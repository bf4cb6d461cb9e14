// Fused patch sampling on a stride lattice, for Hopper (sm_90a).
//
// Replaces, on the VIO path, the Pallas TPU kernel extract_windows_tpu
// (fastlivo_tpu/ops/pallas_windows.py:66) together with its consumer, the
// bilinear lattice and gradient differences of strided_patch_sample
// (fastlivo_tpu/ops/image.py:229-262). One launch computes what the plain
// version (fastlivo_tpu_torch/ops/patch_sample.py) does in ~65-110 eager
// ops: for item (candidate n, level l) of the call,
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
// and writes val (and du, dv) as (N, L, P*P) rows of one (1 or 3, N, L*P*P)
// buffer; the single-level form is L = 1. Nothing intermediate goes to
// device memory.
//
// Numerics. The result equals the plain version on the card bitwise: every
// product, sum and difference is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract
// them into FMAs, and they run in the plain version's order
// (((c00*(1-fu))*(1-fv) + (c01*fu)*(1-fv)) + (c10*(1-fu))*fv) + (c11*fu)*fv.
// Float-to-int goes through the same cvt.rzi as torch's .to(torch.int32)
// on the card (NaN -> 0, saturating); the int32 offsets wrap as torch's do.
//
// Bound: bytes. The least traffic is the image pixels the taps touch, read
// once, the candidate inputs (centers 8 B, stride 4 B, grad_units 4 B), and
// N * L * P^2 * 4 bytes per output array, written once: 0.06-0.2 us at the
// main path's N = 208 and 0.7-2.6 us at N = 4096 at 3.35 TB/s. The frame is
// at most 1344 x 1088 f32 (5.9 MB) and stays in the 50 MB L2, so the
// outputs are most of the bytes; at N = 208 the launch itself dominates.
// What held the earlier one-block-per-item kernel (one thread per
// lattice point) far from that bound at large N was the issue of instructions, not
// bytes: every thread resolved its item itself (two correctly rounded
// divisions among ~60 instructions) for a single lattice point, and the
// 12,288 blocks of the stored form at N = 4096 ran in about 8 waves
// (15.5 us on an H100 80GB HBM3 at 700 W, PERF.md). Its short chain per
// thread (one center read, then four taps) is what keeps small N fast.
//
// Design. Two layouts, both with several items per block and a grid of at
// most as many blocks as the card holds at once (the occupancy API,
// cached per device and shape), walked in a grid-stride loop; both
// resolve an item with an exact multiply by the level's 2^-l, bit for bit
// the plain version's true division.
//
// - Values (select, the stored pyramid): one thread per four consecutive
//   texels of one (candidate, level) item, no shared memory and no
//   barrier. A thread resolves its item, issues the four taps of each of
//   its four lattice points through the read-only path (L1, then the
//   L2-resident frame) before the first use, and writes the four texels
//   with one 16-byte store (rows start at multiples of 16 bytes when P^2
//   is a multiple of 4; P odd falls back to one texel per thread). With
//   stride_set (1,) the four points of a row share their taps: 10 reads,
//   not 16. Blocks are 256 threads (16 items of an 8x8 patch), narrower
//   when that would leave SMs idle (N = 208 at P = 8: 104 blocks of 32).
//   N = 4096 x 3 levels is about one and a half rounds of the grid.
// - Gradients (the update): the earlier kernel's thread per lattice
//   point, two items per block pass (224 threads at P = 8), the lattice and each item's inverse
//   unit in shared memory (its grad_units read issued with the center);
//   after one barrier a thread writes four texels of one row to val, du
//   and dv with three 16-byte stores (one texel when P is no multiple of
//   4). Computing the 14 lattice points of four texels in one thread
//   instead lengthened every thread's chain at N = 208.
//
// Measured and not kept (python tools/patch_sample_ab.py variants,
// PERF.md): one warp per item with its touched pixels staged into shared
// memory by 4-byte cp.async, double-buffered across the warp's items, and
// the same warp reading its taps directly (tools/patch_sample_staged.cu).
// Staging lost to direct taps (a window of 13-38 pixels is a few L1
// lines, and the copy adds a wait to each item's chain), and both lost to
// this kernel: a warp walks an item's lattice serially, a chain that
// threads per point or per texel group run side by side. There is no matrix product for the tensor
// cores. A TMA tile per item would need a tensor map per level encoded on
// the host at every call (the wrapper's host cost is what the main path
// pays per call) for windows at arbitrary origins, of which stride 4 uses
// half the columns; it was not tried.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxLevels = 3;
constexpr int kMaxStrides = 3;
constexpr int kMaxLattice = 16;  // n_lat per axis
constexpr int kThreads = 256;
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

struct Params {
  Levels lv;
  const float* centers;
  const int32_t* strides;
  const float* grad_units;
  int n_items, n_levels, patch, pad;
  int chunk;  // items per block pass (gradient kernel)
  Strides ss;
  // ceil(2^32 / d) for the divisors below: x / d = (x * m) >> 32 for
  // x < 2^32 / d, which every index here is (at most a few thousand).
  unsigned long long by_patch, by_lat, by_lat2, by_units;
  float* out;
  long long plane;  // floats per output array: n_items * patch^2
};

// What a thread needs of its (candidate, level) item.
struct Item {
  const float* img;
  int wp, ou, ov, s;
  float fu, fv, omu, omv;
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

__device__ __forceinline__ int mdiv(int x, unsigned long long m) {
  return (int)(((unsigned long long)(unsigned)x * m) >> 32);
}

unsigned long long magic(int d) { return ((1ull << 32) + (unsigned)d - 1) / (unsigned)d; }

// The candidate n of item it = n * n_levels + l.
__device__ __forceinline__ int item_candidate(const Params& p, int it) {
  return p.n_levels == 1 ? it : (p.n_levels == 2 ? it >> 1 : it / 3);
}

template <bool kGrads>
__device__ __forceinline__ Item describe(const Params& p, int it, int win) {
  constexpr int g = kGrads ? 1 : 0;  // the lattice's one-point border
  const int n = item_candidate(p, it);
  const int l = it - n * p.n_levels;
  // Select the level with constant indices: a dynamic index into the
  // kernel's parameter struct would copy it to local memory.
  Item t;
  const int hp = l == 0 ? p.lv.hp[0] : (l == 1 ? p.lv.hp[1] : p.lv.hp[2]);
  t.wp = l == 0 ? p.lv.wp[0] : (l == 1 ? p.lv.wp[1] : p.lv.wp[2]);
  t.img = l == 0 ? p.lv.img[0] : (l == 1 ? p.lv.img[1] : p.lv.img[2]);

  // centers / 2^l: a multiply by 2^-l rounds the same exact quotient to
  // the same float as the plain version's division (subnormals included).
  const float scale = l == 0 ? 1.0f : (l == 1 ? 0.5f : 0.25f);
  const float cu = __fmul_rn(__ldg(p.centers + 2 * n), scale);
  const float cv = __fmul_rn(__ldg(p.centers + 2 * n + 1), scale);
  const float flu = floorf(cu);
  const float flv = floorf(cv);
  t.fu = __fsub_rn(cu, flu);
  t.fv = __fsub_rn(cv, flv);
  t.omu = __fsub_rn(1.0f, t.fu);
  t.omv = __fsub_rn(1.0f, t.fv);

  const int stride = p.strides != nullptr ? __ldg(p.strides + n) : p.ss.set[0];
  t.s = p.ss.set[0];
#pragma unroll
  for (int k = 1; k < kMaxStrides; ++k) {
    if (k < p.ss.count && stride == p.ss.set[k]) t.s = p.ss.set[k];
  }
  const int back = wrap_mul(stride, p.patch / 2 + g);
  // __float2int_rz is cvt.rzi.s32.f32, torch's float -> int32 on the card.
  t.ou = min(max(wrap_add(wrap_sub(__float2int_rz(flu), back), p.pad), 0), t.wp - win);
  t.ov = min(max(wrap_add(wrap_sub(__float2int_rz(flv), back), p.pad), 0), hp - win);
  return t;
}

__device__ __forceinline__ float bilinear(const Item& t, float c00, float c01, float c10,
                                          float c11) {
  float acc = __fmul_rn(__fmul_rn(c00, t.omu), t.omv);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c01, t.fu), t.omv));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c10, t.omu), t.fv));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c11, t.fu), t.fv));
  return acc;
}

// Lattice point (j, i) of the item: the bilinear tap at origin + s*(i, j).
__device__ __forceinline__ float lat(const Item& t, int j, int i) {
  const float* b = t.img + (size_t)(t.ov + t.s * j) * t.wp + (t.ou + t.s * i);
  return bilinear(t, __ldg(b), __ldg(b + 1), __ldg(b + t.wp), __ldg(b + t.wp + 1));
}

// Values (no gradients): texels o .. o + kCount - 1 of the item, row-major
// in the P x P patch, one lattice point each.
template <int kCount, bool kUnitStride>
__device__ __forceinline__ void sample_values(const Params& p, const Item& t, int o, float* val) {
  if (kCount == 4 && kUnitStride && p.patch % 4 == 0) {
    // One row r, columns c .. c+3 at stride 1: two image rows of 5 pixels.
    const int r = mdiv(o, p.by_patch);
    const float* b = t.img + (size_t)(t.ov + r) * t.wp + (t.ou + o - r * p.patch);
    float top[5], bot[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      top[k] = __ldg(b + k);
      bot[k] = __ldg(b + t.wp + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) val[k] = bilinear(t, top[k], top[k + 1], bot[k], bot[k + 1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCount; ++k) {
    const int r = mdiv(o + k, p.by_patch);
    val[k] = lat(t, r, o + k - r * p.patch);
  }
}

// Values: one thread per four consecutive texels of an item (kVec: P even,
// one 16-byte store) or per texel (P odd), in a grid-stride loop.
// kUnitStride: stride_set is (1,), so a row's four points share taps.
template <bool kVec, bool kUnitStride>
__global__ void __launch_bounds__(kThreads) values_kernel(const Params p) {
  constexpr int kCount = kVec ? 4 : 1;
  const int win = (p.patch - 1) * p.ss.max_s + 2;
  const int p2 = p.patch * p.patch;
  const unsigned per_item = (unsigned)(p2 / kCount);
  const unsigned units = (unsigned)p.n_items * per_item;  // < 2^31 (host check)
  const unsigned step = gridDim.x * blockDim.x;
  unsigned u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  // (item, unit within it), advanced by the grid stride without dividing.
  int it = (int)(u / per_item);
  unsigned q = u - (unsigned)it * per_item;
  const int dit = (int)(step / per_item);
  const unsigned dq = step - (unsigned)dit * per_item;
  for (; u < units; u += step) {
    const Item t = describe<false>(p, it, win);
    const int o = (int)q * kCount;
    float val[kCount];
    sample_values<kCount, kUnitStride>(p, t, o, val);
    float* row = p.out + (size_t)it * p2 + o;
    if (kVec) {
      *reinterpret_cast<float4*>(row) = make_float4(val[0], val[1], val[2], val[3]);
    } else {
      row[0] = val[0];
    }
    it += dit;
    q += dq;
    if (q >= per_item) {
      q -= per_item;
      ++it;
    }
  }
}

__device__ __forceinline__ float half_diff(float a, float b, float inv) {
  return __fmul_rn(__fmul_rn(0.5f, __fsub_rn(a, b)), inv);
}

// Gradients: each block pass takes `chunk` items, one thread per lattice
// point (the earlier kernel's layout, which keeps each thread's chain to
// one center and four taps); the lattice and each item's inverse unit go to shared
// memory. After one barrier each thread writes four texels of one row of
// an item to all three arrays with 16-byte stores (P a multiple of 4; one
// texel otherwise): with g = 1, val = L(r+1, c+1),
// du = L(r+1, c+2) - L(r+1, c), dv = L(r+2, c+1) - L(r, c+1), the
// differences halved and scaled by the inverse unit. The grid walks the
// item chunks.
__global__ void __launch_bounds__(kThreads) grads_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int n_lat = p.patch + 2;
  const int n_lat2 = n_lat * n_lat;
  const int win = (n_lat - 1) * p.ss.max_s + 2;
  const int p2 = p.patch * p.patch;
  const bool quad = p.patch % 4 == 0;
  const int per_item = quad ? p2 >> 2 : p2;  // output threads per item
  float* L = smem;                           // chunk * n_lat2 lattice points
  float* invs = smem + p.chunk * n_lat2;     // chunk inverse units
  for (int it0 = blockIdx.x * p.chunk; it0 < p.n_items; it0 += gridDim.x * p.chunk) {
    const int k_here = min(p.chunk, p.n_items - it0);
    const int e = threadIdx.x;
    if (e < k_here * n_lat2) {
      const int k = mdiv(e, p.by_lat2);
      const int q = e - k * n_lat2;
      // The item's first thread also reads its unit, issued with the
      // center so the division does not wait on a third read.
      float gu = 0.0f;
      if (q == 0) gu = __ldg(p.grad_units + item_candidate(p, it0 + k));
      const int j = mdiv(q, p.by_lat);
      L[e] = lat(describe<true>(p, it0 + k, win), j, q - j * n_lat);
      if (q == 0) {
        gu = isnan(gu) ? gu : fmaxf(gu, (float)1e-9);  // torch.clamp keeps NaN
        invs[k] = __fdiv_rn(1.0f, gu);
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < k_here * per_item; v += blockDim.x) {
      const int k = mdiv(v, p.by_units);
      const int w = v - k * per_item;
      const float* lk = L + k * n_lat2;
      const float inv = invs[k];
      float* row = p.out + (size_t)(it0 + k) * p2;
      if (quad) {
        // Texels (r, c .. c+3): lattice row r+1 at c .. c+5, rows r and
        // r+2 at c+1 .. c+4.
        const int o = w * 4;
        const int r = mdiv(o, p.by_patch);
        const int c = o - r * p.patch;
        const float* mid = lk + (r + 1) * n_lat + c;
        const float* up = lk + r * n_lat + c + 1;
        const float* dn = lk + (r + 2) * n_lat + c + 1;
        float m[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) m[i] = mid[i];
        *reinterpret_cast<float4*>(row + o) = make_float4(m[1], m[2], m[3], m[4]);
        *reinterpret_cast<float4*>(row + p.plane + o) =
            make_float4(half_diff(m[2], m[0], inv), half_diff(m[3], m[1], inv),
                        half_diff(m[4], m[2], inv), half_diff(m[5], m[3], inv));
        *reinterpret_cast<float4*>(row + 2 * p.plane + o) =
            make_float4(half_diff(dn[0], up[0], inv), half_diff(dn[1], up[1], inv),
                        half_diff(dn[2], up[2], inv), half_diff(dn[3], up[3], inv));
      } else {
        const int r = mdiv(w, p.by_patch);
        const int c = w - r * p.patch;
        row[w] = lk[(r + 1) * n_lat + c + 1];
        row[p.plane + w] = half_diff(lk[(r + 1) * n_lat + c + 2], lk[(r + 1) * n_lat + c], inv);
        row[2 * p.plane + w] =
            half_diff(lk[(r + 2) * n_lat + c + 1], lk[r * n_lat + c + 1], inv);
      }
    }
    __syncthreads();  // the lattice is rewritten by the next pass
  }
}

// The card's SM count and how many blocks of `kernel` at (threads, smem)
// fit on one SM, per device (the queries run once per shape).
int occupancy(const void* kernel, int threads, int smem, int* sms, int* per_sm) {
  struct Entry {
    int device;
    const void* kernel;
    int threads, smem, sms, per_sm;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cache = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n_cache; ++k) {
    const Entry& c = cache[k];
    if (c.device == device && c.kernel == kernel && c.threads == threads && c.smem == smem) {
      *sms = c.sms;
      *per_sm = c.per_sm;
      return 0;
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) *per_sm = 1;
  if (n_cache < 64) cache[n_cache++] = Entry{device, kernel, threads, smem, *sms, *per_sm};
  return 0;
}

// Values: blocks of up to 256 threads, narrower when the units would not
// cover every SM (N = 208 at P = 8: 3,328 units, 104 blocks of 32).
template <bool kVec, bool kUnitStride>
int launch_values(const Params& p, unsigned units, cudaStream_t stream) {
  const void* kernel = (const void*)values_kernel<kVec, kUnitStride>;
  int sms = 0, per_sm = 0;
  int err = occupancy(kernel, kThreads, 0, &sms, &per_sm);
  if (err != 0) return err;
  unsigned threads = kThreads;
  if (units < (unsigned)sms * kThreads) {
    const unsigned per = (units + sms - 1) / sms;
    threads = (per + 31) / 32 * 32;
  }
  if (threads != kThreads && (err = occupancy(kernel, (int)threads, 0, &sms, &per_sm)) != 0) return err;
  const unsigned want = (units + threads - 1) / threads;
  const unsigned cap = (unsigned)(sms * per_sm);
  values_kernel<kVec, kUnitStride><<<want < cap ? want : cap, threads, 0, stream>>>(p);
  return 0;
}

int launch_grads(Params& p, cudaStream_t stream) {
  const int n_lat = p.patch + 2;
  const int n_lat2 = n_lat * n_lat;
  p.chunk = kThreads / n_lat2;  // n_lat <= 16, so at least 1
  const int threads = (p.chunk * n_lat2 + 31) / 32 * 32;
  const int smem = p.chunk * (n_lat2 + 1) * (int)sizeof(float);
  const int p2 = p.patch * p.patch;
  p.by_lat = magic(n_lat);
  p.by_lat2 = magic(n_lat2);
  p.by_units = magic(p.patch % 4 == 0 ? p2 / 4 : p2);
  int sms = 0, per_sm = 0;
  const int err = occupancy((const void*)grads_kernel, threads, smem, &sms, &per_sm);
  if (err != 0) return err;
  // As many passes per block as the resident blocks need, and the chunks
  // spread evenly over the blocks.
  const int chunks = (p.n_items + p.chunk - 1) / p.chunk;
  const int cap = sms * per_sm;
  const int passes = (chunks + cap - 1) / cap;
  grads_kernel<<<(chunks + passes - 1) / passes, threads, smem, stream>>>(p);
  return 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). `params` is a host array of 13
// ints: hp0, wp0, hp1, wp1, hp2, wp2, n_levels, patch, pad, s0, s1, s2,
// n_strides (the wrapper keeps one per distinct set). img1/img2 and their
// dims are unused for n_levels < 3; s1/s2 for n_strides < 3. A null
// strides pointer gives every candidate s0; grad_units null means values
// only, and then `out` is (N, L*P^2), else (3, N, L*P^2) for val, du, dv.
// Returns cudaGetLastError() after the launch: a refused launch never
// runs, and only this code says so.
extern "C" int patch_sample(const int* params, const void* img0, const void* img1,
                            const void* img2, const void* centers, const void* strides,
                            const void* grad_units, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int hp0 = params[0], wp0 = params[1], hp1 = params[2], wp1 = params[3];
  const int hp2 = params[4], wp2 = params[5], n_levels = params[6], patch = params[7];
  const int pad = params[8], s0 = params[9], s1 = params[10], s2 = params[11];
  const int n_strides = params[12];
  if (n_levels < 1 || n_levels > kMaxLevels || n_strides < 1 || n_strides > kMaxStrides)
    return (int)cudaErrorInvalidValue;
  const bool grads = grad_units != nullptr;
  const int n_lat = patch + (grads ? 2 : 0);
  if (patch < 1 || n_lat > kMaxLattice) return (int)cudaErrorInvalidValue;
  // Value units (one per four texels, or per texel) must fit 31 bits.
  const bool vec = patch % 2 == 0;
  const long long units = (long long)n * n_levels * patch * patch / (vec ? 4 : 1);
  if (units > 2147483647LL) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.ss.count = n_strides;
  p.ss.set[0] = s0;
  p.ss.set[1] = s1;
  p.ss.set[2] = s2;
  p.ss.max_s = 0;
  for (int k = 0; k < n_strides; ++k) {
    if (p.ss.set[k] < 1) return (int)cudaErrorInvalidValue;
    p.ss.max_s = p.ss.set[k] > p.ss.max_s ? p.ss.set[k] : p.ss.max_s;
  }
  const int win = (n_lat - 1) * p.ss.max_s + 2;
  const void* imgs[kMaxLevels] = {img0, img1, img2};
  const int hps[kMaxLevels] = {hp0, hp1, hp2};
  const int wps[kMaxLevels] = {wp0, wp1, wp2};
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < n_levels && (imgs[l] == nullptr || win > hps[l] || win > wps[l]))
      return (int)cudaErrorInvalidValue;
    p.lv.img[l] = (const float*)imgs[l];
    p.lv.hp[l] = hps[l];
    p.lv.wp[l] = wps[l];
  }
  p.centers = (const float*)centers;
  p.strides = (const int32_t*)strides;
  p.grad_units = (const float*)grad_units;
  p.n_items = n * n_levels;
  p.n_levels = n_levels;
  p.patch = patch;
  p.pad = pad;
  p.chunk = 1;
  p.by_patch = magic(patch);
  p.out = (float*)out;
  p.plane = (long long)p.n_items * patch * patch;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool unit = n_strides == 1 && s0 == 1;
  int err = 0;
  if (grads) {
    err = launch_grads(p, s);
  } else if (vec) {
    err = unit ? launch_values<true, true>(p, (unsigned)units, s)
               : launch_values<true, false>(p, (unsigned)units, s);
  } else {
    err = launch_values<false, false>(p, (unsigned)units, s);
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
