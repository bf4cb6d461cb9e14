// The fused patch sampler of fastlivo_tpu_torch/csrc/patch_sample.cu as one
// warp per (candidate, level) item, kept to be measured against it
// (python tools/patch_sample_ab.py variants; PERF.md). Same function, same
// rounding, same C entry point; only the work layout differs:
//
// Four warps per block and a grid of at most as many blocks as the card
// holds at once (the occupancy API); each warp walks its items with a
// grid-stride loop. Per item the warp stages the pixels its taps touch
// into shared memory with 4-byte cp.async (LDGSTS), row by row with
// neighbouring lanes on neighbouring pixels: at stride 1 the
// (n_lat+1)^2 window, each pixel once instead of four times; at strides 2
// and 4 the 2*n_lat rows and columns o + s*k + {0, 1}. Two staging buffers
// per warp: the next item's pixels are in flight while this item's
// lattice is computed from shared memory. The lattice goes to a per-warp
// shared buffer; after __syncwarp the lanes write each output row with
// 16-byte stores when P is even, scalar stores otherwise. Defined
// PATCH_SAMPLE_DIRECT_TAPS reads the four taps straight from L2 instead
// of the staged pixels.
//
// Numerics: as fastlivo_tpu_torch/csrc/patch_sample.cu (explicitly rounded
// intrinsics in the plain version's order, cvt.rzi, int32 wraps), so it is
// bitwise equal to the plain version too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

#ifdef PATCH_SAMPLE_DIRECT_TAPS
constexpr bool kStaged = false;
#else
constexpr bool kStaged = true;
#endif

constexpr int kMaxLevels = 3;
constexpr int kMaxStrides = 3;
constexpr int kMaxLattice = 16;  // n_lat per axis: a staged row is at most 2 * 16 = 32 lanes
constexpr int kWarps = 4;        // warps (items in flight) per block
constexpr int kThreads = 32 * kWarps;
static_assert(kMaxLevels == 3, "the kernel selects among exactly three levels");
// Per warp at most 2 * 32^2 staged + 16^2 lattice floats = 9 KB, so a
// block stays under the 48 KB of static-size shared memory.
static_assert(kWarps * (2 * 4 * kMaxLattice * kMaxLattice + kMaxLattice * kMaxLattice) * 4 <= 48 * 1024,
              "shared memory per block");

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

// What a warp needs to sample one (candidate, level) item.
struct Item {
  const float* img;
  int wp, ou, ov, s;
  float fu, fv, omu, omv, inv;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Params {
  Levels lv;
  const float* centers;
  const int32_t* strides;
  const float* grad_units;
  int n_items, n_levels, patch, pad;
  Strides ss;
  int buf_floats;  // one staging buffer
  float* out;
  long long plane;  // floats per output array: n_items * patch^2
};

__device__ __forceinline__ Item describe(const Params& p, int it, int g, int win) {
  const int n = it / p.n_levels;
  const int l = it - n * p.n_levels;
  // Select the level with constant indices: a dynamic index into the
  // kernel's parameter struct would copy it to local memory.
  Item t;
  const int hp = l == 0 ? p.lv.hp[0] : (l == 1 ? p.lv.hp[1] : p.lv.hp[2]);
  t.wp = l == 0 ? p.lv.wp[0] : (l == 1 ? p.lv.wp[1] : p.lv.wp[2]);
  t.img = l == 0 ? p.lv.img[0] : (l == 1 ? p.lv.img[1] : p.lv.img[2]);

  const float div = (float)(1 << l);
  const float cu = __fdiv_rn(__ldg(p.centers + 2 * n), div);
  const float cv = __fdiv_rn(__ldg(p.centers + 2 * n + 1), div);
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
  t.inv = 0.0f;
  if (g) {
    float gu = __ldg(p.grad_units + n);
    gu = isnan(gu) ? gu : fmaxf(gu, (float)1e-9);  // torch.clamp keeps NaN
    t.inv = __fdiv_rn(1.0f, gu);
  }
  return t;
}

// Side of the staged square: the rows (and columns) o + s*k + {0, 1} for
// k < n_lat, which are n_lat + 1 distinct ones at stride 1 and 2 * n_lat
// otherwise. Staged row r holds image row o + s*(r/q) + r%q, q = 1 or 2.
__device__ __forceinline__ int staged_side(int s, int n_lat) {
  return s == 1 ? n_lat + 1 : 2 * n_lat;
}

// Issue the item's staging copies (no wait): lanes cover 32 / side rows
// per pass, neighbouring lanes on neighbouring staged columns.
__device__ __forceinline__ void stage(const Item& t, float* buf, int lane, int n_lat) {
  const int side = staged_side(t.s, n_lat);
  const int q = t.s == 1 ? 1 : 2;
  const int per_pass = 32 / side;
  const int rr = lane / side;
  const int c = lane - rr * side;
  if (rr >= per_pass) return;
  const int gc = t.s * (c / q) + (c % q);
  const float* col = t.img + t.ou + gc;
  for (int r = rr; r < side; r += per_pass) {
    const int gr = t.s * (r / q) + (r % q);
    cp_async4(buf + r * side + c, col + (size_t)(t.ov + gr) * t.wp);
  }
}

__device__ __forceinline__ float bilinear(const Item& t, float c00, float c01, float c10,
                                          float c11) {
  float acc = __fmul_rn(__fmul_rn(c00, t.omu), t.omv);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c01, t.fu), t.omv));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c10, t.omu), t.fv));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c11, t.fu), t.fv));
  return acc;
}

// Lattice point j*n_lat + i of the item, from the staged pixels or (the
// direct-tap build) from the image itself.
__device__ __forceinline__ float lattice_point(const Item& t, const float* buf, int j, int i,
                                               int n_lat) {
  if (kStaged) {
    const int side = staged_side(t.s, n_lat);
    const int q = t.s == 1 ? 1 : 2;
    const float* b = buf + (q * j) * side + q * i;
    return bilinear(t, b[0], b[1], b[side], b[side + 1]);
  }
  const float* b = t.img + (size_t)(t.ov + t.s * j) * t.wp + (t.ou + t.s * i);
  return bilinear(t, __ldg(b), __ldg(b + 1), __ldg(b + t.wp), __ldg(b + t.wp + 1));
}

// Output texel o (row-major in the P x P patch) of array a (0 val, 1 du,
// 2 dv) from the lattice.
__device__ __forceinline__ float texel(const float* lat, const Item& t, int a, int o, int patch,
                                       int n_lat, int g) {
  const int r = o / patch;
  const int c = o - r * patch;
  if (a == 0) return lat[(r + g) * n_lat + c + g];
  const float d = a == 1 ? __fsub_rn(lat[(r + g) * n_lat + c + 2], lat[(r + g) * n_lat + c])
                         : __fsub_rn(lat[(r + 2) * n_lat + c + g], lat[r * n_lat + c + g]);
  return __fmul_rn(__fmul_rn(0.5f, d), t.inv);
}

__global__ void __launch_bounds__(kThreads) patch_sample_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = p.grad_units != nullptr ? 1 : 0;
  const int n_lat = p.patch + 2 * g;
  const int win = (n_lat - 1) * p.ss.max_s + 2;
  const int p2 = p.patch * p.patch;
  const int n_arr = g ? 3 : 1;

  float* bufs = smem + warp * (2 * p.buf_floats + n_lat * n_lat);
  float* lat = bufs + 2 * p.buf_floats;

  const int step = gridDim.x * kWarps;
  int it = blockIdx.x * kWarps + warp;
  if (it >= p.n_items) return;  // warp-uniform; the kernel has no block barrier
  Item cur = describe(p, it, g, win);
  int b = 0;
  if (kStaged) {
    stage(cur, bufs, lane, n_lat);
    cp_async_commit();
  }
  for (; it < p.n_items; it += step) {
    const int nxt = it + step;
    Item next = cur;
    if (nxt < p.n_items) next = describe(p, nxt, g, win);
    const float* buf = bufs + b * p.buf_floats;
    if (kStaged) {
      if (nxt < p.n_items) stage(next, bufs + (b ^ 1) * p.buf_floats, lane, n_lat);
      cp_async_commit();  // an empty group on the last item keeps the count
      cp_async_wait_all_but_newest();
      __syncwarp();
    }
    for (int e = lane; e < n_lat * n_lat; e += 32) {
      const int j = e / n_lat;
      lat[e] = lattice_point(cur, buf, j, e - j * n_lat, n_lat);
    }
    __syncwarp();

    float* row = p.out + (size_t)it * p2;
    if ((p2 & 3) == 0) {
      const int per = p2 >> 2;
      for (int v = lane; v < n_arr * per; v += 32) {
        const int a = v / per;
        const int o = (v - a * per) * 4;
        float4 w;
        w.x = texel(lat, cur, a, o, p.patch, n_lat, g);
        w.y = texel(lat, cur, a, o + 1, p.patch, n_lat, g);
        w.z = texel(lat, cur, a, o + 2, p.patch, n_lat, g);
        w.w = texel(lat, cur, a, o + 3, p.patch, n_lat, g);
        *reinterpret_cast<float4*>(row + a * p.plane + o) = w;
      }
    } else {
      for (int v = lane; v < n_arr * p2; v += 32) {
        const int a = v / p2;
        const int o = v - a * p2;
        row[a * p.plane + o] = texel(lat, cur, a, o, p.patch, n_lat, g);
      }
    }
    __syncwarp();  // lat and this buffer are rewritten for the item after next
    cur = next;
    b ^= 1;
  }
}

// Blocks resident on the whole card at a shared-memory size, per device
// (the occupancy query runs once per pair).
int max_blocks(int smem, int* blocks) {
  struct Entry {
    int device, smem, blocks;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int n_cache = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n_cache; ++k) {
    if (cache[k].device == device && cache[k].smem == smem) {
      *blocks = cache[k].blocks;
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_sample_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (n_cache < 16) cache[n_cache++] = Entry{device, smem, *blocks};
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
  if (n_levels < 1 || n_levels > kMaxLevels || n_strides < 1 || n_strides > kMaxStrides ||
      n > 2147483647 / kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const int grads = grad_units != nullptr ? 1 : 0;
  const int n_lat = patch + 2 * grads;
  if (patch < 1 || n_lat > kMaxLattice) return (int)cudaErrorInvalidValue;
  Params p;
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
  const int side = p.ss.max_s == 1 ? n_lat + 1 : 2 * n_lat;  // the larger staged square
  p.buf_floats = kStaged ? side * side : 0;
  p.out = (float*)out;
  p.plane = (long long)p.n_items * patch * patch;

  const int smem = kWarps * (2 * p.buf_floats + n_lat * n_lat) * (int)sizeof(float);
  int blocks = 0;
  const int err = max_blocks(smem, &blocks);
  if (err != 0) return err;
  const int want = (p.n_items + kWarps - 1) / kWarps;
  patch_sample_kernel<<<want < blocks ? want : blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
