"""fastlivo_tpu_torch — the PyTorch / CUDA port of fastlivo_tpu.

The JAX package ``fastlivo_tpu`` is the reference; this package mirrors its
module paths and function names (``state``, ``ops/so3``, ``maps/voxel_map``,
``models/vio`` ...) so each function has an obvious counterpart, and holds
its own copy of everything it needs: it never imports jax or fastlivo_tpu.

Ported so far: the single-device LIVO cycle — ``bootstrap_map``, then
``lio_scan_step`` (surfel, point-to-plane or VGICP) followed by
``vio_scan_step`` — with the one Pallas kernel of that path
(``extract_windows``) rewritten as CUDA kernels for sm_90a
(``csrc/extract_windows.cu``, fused into ``csrc/patch_sample.cu``); the
host pipeline and CLI (``models/pipeline.LivoPipeline``, ``run``); and the
back end: GNSS fusion (``models/gnss``), STD loop closure with its pose
graph (``backend/``), the SuperPoint+LightGlue loop gate
(``backend/superpoint_lightglue``, ``backend/visual_verify``) and
loop-corrected map re-anchoring.

Device rule: constructors and converters take ``device=None``, meaning
CUDA (they raise when no GPU is present); every step function runs on the
device of its inputs. Tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# Filter numerics need true f32 products: TF32 keeps ~3 decimal digits,
# far above the IESKF's convergence thresholds (0.01 deg / 0.15 mm). The
# counterpart of the matmul-precision pin in fastlivo_tpu/__init__.py.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from fastlivo_tpu_torch.state import NavState  # noqa: E402,F401
