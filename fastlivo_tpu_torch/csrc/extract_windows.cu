// Batched extraction of per-candidate image windows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel extract_windows_tpu
// (fastlivo_tpu/ops/pallas_windows.py:66, body _window_kernel :49): for N
// candidates, copy the (win, win) f32 block whose top-left corner is
// starts[i] = (ou, ov) out of a zero-padded (hp, wp) image into
// out[i] (N, win, win). An exact copy: the port's plain version and this
// kernel agree bitwise.
//
// Design. One thread block per window; its threads stride over the
// win*win elements in row-major order, so neighbouring threads read
// neighbouring columns of one image row (coalesced loads) and write
// neighbouring output words. Rows are read straight from device memory:
// the padded camera frame is at most 704 x 576 f32 = 1.6 MB and stays in
// the 50 MB L2 across the frame's launches. The TPU kernel's aligned
// superset fetch with pltpu.roll, its re-padded image and its VMEM size
// gate existed only for Mosaic's (8, 128) tiling and VMEM; none of that
// applies here.
//
// Bound. The kernel moves 2 * N * win^2 * 4 bytes (each window read once,
// written once): 2.4 MB at N = 208, win = 38, about 0.7 us at 3.35 TB/s.
// At the main path's sizes a launch costs more than that, so the kernel is
// bound by launch latency. The VIO path therefore reads its patches through
// patch_sample.cu, which fuses this copy with the bilinear lattice of
// strided_patch_sample; this kernel stays as the TPU kernel's counterpart.
//
// Corners are clamped to [0, dim - win] here as well as by the caller, so
// no start value can make the kernel read outside the image.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void extract_windows_kernel(const float* __restrict__ img, int hp,
                                       int wp, const int32_t* __restrict__ starts,
                                       int win, float* __restrict__ out) {
  const int i = blockIdx.x;
  int ou = starts[2 * i];
  int ov = starts[2 * i + 1];
  ou = min(max(ou, 0), wp - win);
  ov = min(max(ov, 0), hp - win);
  const float* src = img + (size_t)ov * wp + ou;
  float* dst = out + (size_t)i * win * win;
  const int total = win * win;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / win;
    const int c = e - r * win;
    dst[e] = src[(size_t)r * wp + c];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch: a refused launch never runs, and only this code says so.
extern "C" int extract_windows(const void* img, int hp, int wp,
                               const void* starts, int n, int win, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  if (win <= 0 || win > hp || win > wp) return (int)cudaErrorInvalidValue;
  int threads = ((win * win + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  extract_windows_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, hp, wp, (const int32_t*)starts, win, (float*)out);
  return (int)cudaGetLastError();
}
