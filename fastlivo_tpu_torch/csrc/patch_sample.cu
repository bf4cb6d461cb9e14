// Fused patch sampling on a stride lattice, for Hopper (sm_90a).
//
// Replaces, on the VIO path, the Pallas TPU kernel extract_windows_tpu
// (fastlivo_tpu/ops/pallas_windows.py:66) together with its consumer, the
// bilinear lattice and gradient differences of strided_patch_sample
// (fastlivo_tpu/ops/image.py:229-262). One launch computes what the plain
// version (fastlivo_tpu_torch/ops/patch_sample.py) does in ~65-110 eager
// ops: for candidate n on level l of the call (grid (N, L)),
//
//   c      = centers[n] / 2^l                     (true division)
//   i0     = (int)floor(c), frac = c - floor(c)
//   origin = clamp(i0 - stride*(half+g) + pad, 0, dim - win)
//   win    = (n_lat - 1) * max(stride_set) + 2,  n_lat = P + 2g
//   lat[j][i] = bilinear tap at origin + s*(i, j) with the shared frac,
//            s = the candidate's stride if it is in stride_set, else
//            stride_set[0] (the plain version's torch.where chain)
//   val = lat[g:g+P, g:g+P]; du, dv = 0.5 * (central difference) * inv,
//   inv = 1 / max(grad_units[n], 1e-9)
//
// and writes val (and du, dv) as (N, L, P*P) rows; the single-level form
// is L = 1. Nothing intermediate goes to device memory.
//
// Numerics. The result equals the plain version on the card bitwise: every
// product, sum and difference is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract
// them into FMAs, and they run in the plain version's order
// (((c00*(1-fu))*(1-fv) + (c01*fu)*(1-fv)) + (c10*(1-fu))*fv) + (c11*fu)*fv.
// Float-to-int goes through the same cvt.rzi as torch's .to(torch.int32)
// on the card (NaN -> 0, saturating); the int32 offsets wrap as torch's do.
//
// Design. One thread block per (candidate, level). Each thread computes
// one lattice point (n_lat^2 <= 144 points) from four taps read through
// the read-only path: the padded frame is at most 704 x 576 f32 = 1.6 MB
// and stays in the 50 MB L2 for the whole frame. The lattice goes to
// shared memory; after one barrier each thread writes one texel of val,
// du and dv, so the stores are coalesced. There is no matrix product for
// the tensor cores, and at 13-38-pixel windows no tile is worth a TMA
// descriptor's set-up.
//
// Bound: bytes. The least traffic is the image pixels the taps touch, read
// once, the candidate inputs (centers 8 B, stride 4 B, grad_units 4 B),
// and N * L * P^2 * 4 bytes per output array, written once. At the main
// path's N = 208 that is well under a microsecond at 3.35 TB/s, so the
// launch itself dominates; what this kernel saves is the eager chain of
// small launches it replaces.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kMaxStrides = 3;
constexpr int kMaxLattice = 16;  // n_lat per axis, so lat fits in 1 KB
static_assert(kMaxLevels == 3, "the kernel selects among exactly three levels");

struct Levels {
  const float* img[kMaxLevels];
  int hp[kMaxLevels];
  int wp[kMaxLevels];
};

struct Strides {
  int set[kMaxStrides];
  int count;
  int max_s;
};

// int32 add/subtract/multiply with torch's two's-complement wrap (signed
// overflow is undefined in C++, so go through unsigned).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__global__ void patch_sample_kernel(Levels lv, const float* __restrict__ centers,
                                    const int32_t* __restrict__ strides,
                                    const float* __restrict__ grad_units,
                                    int patch, int pad, Strides ss,
                                    float* __restrict__ val, float* __restrict__ du,
                                    float* __restrict__ dv) {
  __shared__ float lat[kMaxLattice * kMaxLattice];
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const int n_levels = gridDim.y;
  const int g = grad_units != nullptr ? 1 : 0;
  const int half = patch / 2;
  const int n_lat = patch + 2 * g;
  const int win = (n_lat - 1) * ss.max_s + 2;
  // Select the level with constant indices: a dynamic index into the
  // kernel's parameter struct would copy it to local memory.
  const int hp = l == 0 ? lv.hp[0] : (l == 1 ? lv.hp[1] : lv.hp[2]);
  const int wp = l == 0 ? lv.wp[0] : (l == 1 ? lv.wp[1] : lv.wp[2]);
  const float* __restrict__ img = l == 0 ? lv.img[0] : (l == 1 ? lv.img[1] : lv.img[2]);

  const float div = (float)(1 << l);
  const float cu = __fdiv_rn(__ldg(centers + 2 * n), div);
  const float cv = __fdiv_rn(__ldg(centers + 2 * n + 1), div);
  const float flu = floorf(cu);
  const float flv = floorf(cv);
  const float fu = __fsub_rn(cu, flu);
  const float fv = __fsub_rn(cv, flv);
  const float omu = __fsub_rn(1.0f, fu);
  const float omv = __fsub_rn(1.0f, fv);

  const int stride = strides != nullptr ? __ldg(strides + n) : ss.set[0];
  int s = ss.set[0];
#pragma unroll
  for (int k = 1; k < kMaxStrides; ++k) {
    if (k < ss.count && stride == ss.set[k]) s = ss.set[k];
  }
  const int back = wrap_mul(stride, half + g);
  // __float2int_rz is cvt.rzi.s32.f32, torch's float -> int32 on the card.
  const int ou = min(max(wrap_add(wrap_sub(__float2int_rz(flu), back), pad), 0), wp - win);
  const int ov = min(max(wrap_add(wrap_sub(__float2int_rz(flv), back), pad), 0), hp - win);

  const int t = threadIdx.x;
  if (t < n_lat * n_lat) {
    const int j = t / n_lat;
    const int i = t - j * n_lat;
    const float* p = img + (size_t)(ov + s * j) * wp + (ou + s * i);
    const float c00 = __ldg(p);
    const float c01 = __ldg(p + 1);
    const float c10 = __ldg(p + wp);
    const float c11 = __ldg(p + wp + 1);
    float acc = __fmul_rn(__fmul_rn(c00, omu), omv);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c01, fu), omv));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c10, omu), fv));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c11, fu), fv));
    lat[t] = acc;
  }
  __syncthreads();

  const int p2 = patch * patch;
  if (t < p2) {
    const int r = t / patch;
    const int c = t - r * patch;
    const size_t o = ((size_t)n * n_levels + l) * p2 + t;
    const int row = (r + g) * n_lat;
    val[o] = lat[row + c + g];
    if (g) {
      float gu = __ldg(grad_units + n);
      gu = isnan(gu) ? gu : fmaxf(gu, (float)1e-9);  // torch.clamp keeps NaN
      const float inv = __fdiv_rn(1.0f, gu);
      du[o] = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(lat[row + c + 2], lat[row + c])), inv);
      dv[o] = __fmul_rn(
          __fmul_rn(0.5f, __fsub_rn(lat[(r + 2) * n_lat + c + g], lat[r * n_lat + c + g])),
          inv);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). imgs/hps/wps are host arrays of
// n_levels entries, stride_set a host array of n_strides entries. A null
// strides pointer gives every candidate stride_set[0]; the device pointers
// grad_units, du and dv are all null (values only) or all set. Returns cudaGetLastError() after the launch: a refused launch never
// runs, and only this code says so.
extern "C" int patch_sample(const uint64_t* imgs, const int* hps, const int* wps,
                            int n_levels, const void* centers, const void* strides,
                            const void* grad_units, int n, int patch, int pad,
                            const int* stride_set, int n_strides, void* val, void* du,
                            void* dv, void* stream) {
  if (n <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || n_strides < 1 || n_strides > kMaxStrides ||
      n > 2147483647 / kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const bool grads = grad_units != nullptr;
  if (grads != (du != nullptr) || grads != (dv != nullptr)) return (int)cudaErrorInvalidValue;
  const int n_lat = patch + (grads ? 2 : 0);
  if (patch < 1 || n_lat > kMaxLattice) return (int)cudaErrorInvalidValue;
  Strides ss;
  ss.count = n_strides;
  ss.max_s = 0;
  for (int k = 0; k < n_strides; ++k) {
    if (stride_set[k] < 1) return (int)cudaErrorInvalidValue;
    ss.set[k] = stride_set[k];
    ss.max_s = stride_set[k] > ss.max_s ? stride_set[k] : ss.max_s;
  }
  const int win = (n_lat - 1) * ss.max_s + 2;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    if (win > hps[l] || win > wps[l]) return (int)cudaErrorInvalidValue;
    lv.img[l] = (const float*)imgs[l];
    lv.hp[l] = hps[l];
    lv.wp[l] = wps[l];
  }
  const int threads = ((n_lat * n_lat + 31) / 32) * 32;  // n_lat >= patch
  const dim3 grid((unsigned)n, (unsigned)n_levels);
  patch_sample_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      lv, (const float*)centers, (const int32_t*)strides, (const float*)grad_units, patch,
      pad, ss, (float*)val, (float*)du, (float*)dv);
  return (int)cudaGetLastError();
}
