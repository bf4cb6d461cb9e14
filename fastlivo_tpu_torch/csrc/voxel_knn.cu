// k nearest map points per query over a voxel stencil, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's knn
// (fastlivo_tpu/maps/voxel_map.py:640) is a plain loop of lax.top_k merges
// that XLA fuses. The port's plain version (knn_plain in
// fastlivo_tpu_torch/maps/voxel_map.py) runs it op by op: one batched
// bucket probe for the whole stencil, then per stencil offset a slab-row
// gather, the distances and a stable sort of (N, k + max_points) rows,
// about 350 launches a search with 19 offsets. This kernel computes the
// same function in one launch and returns the same bits.
//
// Semantics, per query q (the plain version's, made explicit):
//   voxel v = int(clamp(floor(q * (1 / resolution)), +-kCoordMax)), the
//     product by the reciprocal as PyTorch's CUDA division by a scalar;
//   for each stencil offset o, in order: the bucket rows b1 = hash(v + o),
//     b2 = hash2(v + o) (int32 products that wrap, here in uint32); the
//     slot found is the first lane, b1's probe_depth lanes then b2's,
//     whose three keys equal v + o in the meta dtype and whose first key
//     is not kEmpty; its first counts[slot] slab points are candidates,
//     in slot order;
//   the result is the k smallest entries under (d2, offset, slot) of the
//     stable merge, seeded with k entries (inf, 0-point) that rank first
//     among equal d2: a candidate enters only if its d2 is strictly below
//     the k-th best, and goes in after every entry with an equal d2. So
//     an invalid, NaN or inf candidate never enters, an entry left at inf
//     keeps its zero point, and an entry with a finite d2 above max_dist2
//     keeps its real point with valid false.
//   d2 = ((dx dx) + (dz dz)) + (dy dy), each step rounded (the explicit
//     _rn intrinsics keep nvcc from contracting them into FMAs), as the
//     plain version's sub, pow and sum do on the card: PyTorch's CUDA sum
//     over a last dim of 3 runs on two threads, one adding elements 0 and
//     2, then the other's element 1 (on the CPU it adds them in order).
//
// Bound: the chain of dependent reads, not bytes. Per query and offset
// the kernel reads two bucket rows of meta (2 x 8 slots x 8 words), then
// one count and one slab row (384 B in float32, 768 B in float64), each
// read waiting on the one before, 19 offsets in a row. The least bytes of
// a room search (16,384 queries) are the distinct rows the stencil
// touches, ~7 MB in float32: ~2 us at 3.35 TB/s; without reuse the reads
// are ~0.2 GB, which L1 and L2 serve, since neighbouring queries share
// stencil voxels (they arrive in the downsample's voxel order). What is
// left is L2 latency times the chain, hidden by the warps resident at once.
//
// Design. One warp per query. Lane l of the probe reads slot l of the two
// bucket rows (probe_depth <= 16 in one pass, more in passes of 32); a
// ballot finds the first matching lane. Lane i of the merge reads slab
// point i (max_points <= 32 in one pass, more in passes of 32), so a slab
// row is one coalesced read. Lanes 0..k-1 hold the running best k, sorted,
// one entry a lane. A ballot finds the lanes whose d2 is below the k-th
// best; they are inserted one at a time in ascending lane order: a second
// ballot counts the entries with d2 <= the candidate's (its place), the
// entries from there shift one lane up (shfl_up), and the threshold is
// read again from lane k-1, which prunes the remaining lanes.
//
// The C entry point takes device pointers and the stencil as host ints
// (passed to the kernel by value), launches on the caller's stream, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;       // 8 warps, one query each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;
constexpr int kMaxOffsets = 27;
constexpr int kW = 8;               // packed meta row: [kx, ky, kz, stamp, n, s1x, s1y, s1z]
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEmpty = double(1 << 26);
constexpr double kCoordMax = double((1 << 22) - 1);

struct Stencil {
  int n;
  int d[kMaxOffsets][3];
};

__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float inf_(float) { return CUDART_INF_F; }
__device__ __forceinline__ double inf_(double) { return CUDART_INF; }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float clamp_(float x, float lim) { return fminf(fmaxf(x, -lim), lim); }
__device__ __forceinline__ double clamp_(double x, double lim) { return fmin(fmax(x, -lim), lim); }

// voxel_coord: floor, clamp (NaN passes through, as torch.clamp), int32
// cast (NaN -> 0, as the card's conversion).
template <typename T>
__device__ __forceinline__ int voxel_of(T x, T inv_res) {
  T v = floor_(mul_(x, inv_res));
  if (!isnan(v)) v = clamp_(v, T(kCoordMax));
  return static_cast<int>(v);
}

// _hash / _hash2: the int32 products wrap; in uint32 the wrap is defined.
template <unsigned P0, unsigned P1, unsigned P2>
__device__ __forceinline__ int bucket(int x, int y, int z, unsigned n_buckets) {
  const unsigned h = (unsigned(x) * P0) ^ (unsigned(y) * P1) ^ (unsigned(z) * P2);
  return int((h & 0x7fffffffu) % n_buckets);
}

template <typename T>
struct Args {
  const T* queries;           // (n, 3)
  const T* meta;              // (n_buckets, probe_depth * 8)
  const int* counts;          // (capacity,)
  const T* slab;              // (capacity, max_points * 3)
  T* out_pts;                 // (n, k, 3)
  T* out_d2;                  // (n, k)
  bool* out_valid;            // (n, k)
  int n, n_buckets, probe_depth, max_points, k;
  T inv_res, max_d2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) knn_kernel(const Args<T> a, const Stencil st) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= a.n) return;  // the whole warp
  const T qx = a.queries[3 * q], qy = a.queries[3 * q + 1], qz = a.queries[3 * q + 2];
  const int vx = voxel_of(qx, a.inv_res), vy = voxel_of(qy, a.inv_res), vz = voxel_of(qz, a.inv_res);
  const T inf = inf_(T(0));
  const int pd = a.probe_depth, lanes = 2 * pd, k = a.k;
  const T empty = T(kEmpty);

  T bd = inf, bx = T(0), by = T(0), bz = T(0);  // lane j < k: the j-th best
  T thr = inf;                                   // the k-th best d2, on every lane

  for (int o = 0; o < st.n; ++o) {
    const int cx = vx + st.d[o][0], cy = vy + st.d[o][1], cz = vz + st.d[o][2];
    const int b1 = bucket<98317u, 1222827239u, 51787565u>(cx, cy, cz, a.n_buckets);
    const int b2 = bucket<40503u, 1610612741u, 179424673u>(cx, cy, cz, a.n_buckets);
    const T fx = T(cx), fy = T(cy), fz = T(cz);
    int found = -1;
    for (int base = 0; base < lanes; base += 32) {
      const int l = base + lane;
      bool hit = false;
      int slot = 0;
      if (l < lanes) {
        slot = l < pd ? b1 * pd + l : b2 * pd + (l - pd);
        const T* row = a.meta + size_t(slot) * kW;
        const T k0 = row[0];
        hit = k0 == fx && row[1] == fy && row[2] == fz && k0 != empty;
      }
      const unsigned m = __ballot_sync(kFull, hit);
      if (m) {
        found = __shfl_sync(kFull, slot, __ffs(m) - 1);
        break;
      }
    }
    if (found < 0) continue;
    const int cnt = a.counts[found];
    const T* row = a.slab + size_t(found) * a.max_points * 3;
    for (int base = 0; base < a.max_points; base += 32) {
      const int i = base + lane;
      const bool ok = i < a.max_points && i < cnt;
      T d2 = inf, px = T(0), py = T(0), pz = T(0);
      if (ok) {
        px = row[3 * i];
        py = row[3 * i + 1];
        pz = row[3 * i + 2];
        const T dx = sub_(px, qx), dy = sub_(py, qy), dz = sub_(pz, qz);
        d2 = add_(add_(mul_(dx, dx), mul_(dz, dz)), mul_(dy, dy));
      }
      unsigned m = __ballot_sync(kFull, ok && d2 < thr);
      while (m) {
        const int c = __ffs(m) - 1;
        const T cd = __shfl_sync(kFull, d2, c);
        const T cpx = __shfl_sync(kFull, px, c), cpy = __shfl_sync(kFull, py, c),
                cpz = __shfl_sync(kFull, pz, c);
        const int pos = __popc(__ballot_sync(kFull, lane < k && bd <= cd));
        const T ud = __shfl_up_sync(kFull, bd, 1), ux = __shfl_up_sync(kFull, bx, 1),
                uy = __shfl_up_sync(kFull, by, 1), uz = __shfl_up_sync(kFull, bz, 1);
        if (lane == pos) {
          bd = cd; bx = cpx; by = cpy; bz = cpz;
        } else if (lane > pos && lane < k) {
          bd = ud; bx = ux; by = uy; bz = uz;
        }
        thr = __shfl_sync(kFull, bd, k - 1);
        m &= m - 1;  // c is done
        m &= __ballot_sync(kFull, ok && d2 < thr);
      }
    }
  }
  if (lane < k) {
    const size_t e = size_t(q) * k + lane;
    a.out_pts[3 * e] = bx;
    a.out_pts[3 * e + 1] = by;
    a.out_pts[3 * e + 2] = bz;
    a.out_d2[e] = bd;
    a.out_valid[e] = bd <= a.max_d2;
  }
}

template <typename T>
int launch(const void* queries, int n, const void* meta, const int* counts, const void* slab,
           int n_buckets, int probe_depth, int max_points, const Stencil& st, int k,
           double resolution, double max_dist2, void* out_pts, void* out_d2, void* out_valid,
           cudaStream_t stream) {
  const Args<T> a = {
      static_cast<const T*>(queries), static_cast<const T*>(meta), counts,
      static_cast<const T*>(slab),    static_cast<T*>(out_pts),    static_cast<T*>(out_d2),
      static_cast<bool*>(out_valid),  n, n_buckets, probe_depth, max_points, k,
      T(1) / T(resolution),  // PyTorch's CUDA division by a scalar: the reciprocal in T
      T(max_dist2)};
  const int blocks = (n + kWarps - 1) / kWarps;
  knn_kernel<T><<<blocks, kThreads, 0, stream>>>(a, st);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 float, 1 double (queries, meta and slab alike). queries (n, 3);
// meta (n_buckets, probe_depth * 8); counts (n_buckets * probe_depth,)
// int32; slab (n_buckets * probe_depth, max_points * 3); offsets: n_off x 3
// host ints, the stencil in order; outputs (n, k, 3), (n, k) and (n, k)
// bool bytes. n >= 1, 1 <= k <= 16, 1 <= n_off <= 27. Returns a
// cudaError_t.
extern "C" int voxel_knn(int kind, const void* queries, int n, const void* meta, const int* counts,
                         const void* slab, int n_buckets, int probe_depth, int max_points,
                         const int* offsets, int n_off, int k, double resolution, double max_dist2,
                         void* out_pts, void* out_d2, void* out_valid, void* stream) {
  if (n < 1 || k < 1 || k > kMaxK || n_off < 1 || n_off > kMaxOffsets || n_buckets < 1 ||
      probe_depth < 1 || max_points < 1)
    return (int)cudaErrorInvalidValue;
  Stencil st;
  st.n = n_off;
  for (int i = 0; i < n_off; ++i)
    for (int c = 0; c < 3; ++c) st.d[i][c] = offsets[3 * i + c];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float>(queries, n, meta, counts, slab, n_buckets, probe_depth, max_points, st, k,
                           resolution, max_dist2, out_pts, out_d2, out_valid, s);
    case 1:
      return launch<double>(queries, n, meta, counts, slab, n_buckets, probe_depth, max_points, st,
                            k, resolution, max_dist2, out_pts, out_d2, out_valid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
