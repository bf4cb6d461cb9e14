"""The benchmark's plain reference of the on-line LIVO path, written from
the mathematics in plain PyTorch, in float64 by default.

It shares no code with the port (`fastlivo_tpu_torch`) and imports nothing
of it, of `fastlivo_tpu` or of JAX. What it implements is the path's
stated semantics, each in a few plain lines:

- `records`: the measurement groups a record stream makes (scan-end groups,
  image-bounded groups), their IMU windows and point slices, and the
  static initialization from the rest at the start;
- `lio`: IMU propagation of the state and its covariance, motion
  compensation of each point, the centroid voxel filter, the point map as
  voxels of points, k nearest neighbours over the voxel stencil, the
  least-squares plane through them, the iterated error-state Kalman update
  with the point-to-plane measurement, and the map's insert rule;
- `vio`: the image pyramid, bilinear patch sampling with central
  differences, the per-cell choice of visual map points with its depth and
  view gates, the affine warp of the stored reference patch, and the
  coarse-to-fine photometric iterated update with exposure compensation;
- `arith`: SO(3), and the matrix product through which every matmul runs
  (`Arith(tf32=True)` rounds its operands as TF32 does: the control).

`camera` and `params` are the pinhole model and the configuration's
values as the reference reads them; the pool and the renderer use them
too.
"""
