// IMU forward propagation over one measurement window, for Hopper (sm_90a).
//
// Replaces the JAX package's lax.scan in propagate
// (fastlivo_tpu/models/imu.py:57-158), which has no Pallas kernel: XLA
// compiles the scan into one loop on the TPU. The port's plain version
// (propagate_plain in fastlivo_tpu_torch/models/imu.py) runs it as two
// Python loops over the window's M - 1 intervals, about 1,100 launches of
// a few microseconds each for M = 128; this kernel computes the same
// function in one launch:
//
//   gyr_avg[i] = 0.5 (gyr[i] + gyr[i+1]) - bg
//   acc_avg[i] = 0.5 (acc[i] + acc[i+1]) acc_scale - ba
//   dt[i]      = max((stamps[i+1] - stamps[i]) mask[i+1], 0)
//   rot[i+1]   = rot[i] Exp(gyr_avg[i] dt[i])
//   acc_w[i+1] = rot[i+1] acc_avg[i] + grav,  acc_w[0] = rot[0] acc_avg[0] + grav
//   cov        = F_i cov F_i^T + Q_i   (F_i, Q_i from rot[i], acc_avg[i], dt[i])
//   pos[i+1]   = pos[i] + vel[i] dt + 0.5 acc_w[i+1] dt^2,  vel[i+1] = vel[i] + acc_w[i+1] dt
//
// then the extrapolation from the last valid sample (the mask's count) to
// t_end. Sums over the window's samples run in the window's dtype W and
// are cast to the state's dtype T, as the plain version's type promotion
// does. The order of the sums inside each 3x3 and 18x18 product is the
// kernel's own (cuBLAS picks another on the plain path), and nvcc
// contracts products and sums into FMAs, so the two agree to rounding, not
// bit for bit.
//
// Bound: the dependent chain. The kernel moves 34 KB in float64 at M = 128
// (the state and the window read once, 339 + 21 M outputs written once),
// 10 ns at 3.35 TB/s. What it cannot shorten is the recursion: each valid
// interval is two 18x18 products in a row, each entry a chain of dependent
// FMAs over F's nonzeros (up to 8 a row) read from shared memory, and the
// 3x3 rotation chain runs through every interval. A 10 Hz sweep with
// 200 Hz IMU fills ~21 of 128 slots: ~20 x 2 chains of up to 8 dependent
// FMAs plus two barriers an interval, a few microseconds in float64.
// Dense 18-term products would read 93 KB of shared memory each in
// float64, ~730 cycles at 128 B a cycle; an interval cost ~2,600 cycles
// that way on an H100.
//
// Design. One block, because the recursion is sequential and the whole
// state fits one SM's shared memory: 384 threads, one per covariance entry
// (324) rounded up to warps. Phases, separated by __syncthreads:
//   A. every thread, one interval at a time: the averages, dt, and
//      Exp(w dt) into shared memory; gyr_b straight to the output.
//   B. warp 0: the rotation chain, lane (r, c) holding rot[r][c] and
//      taking its row from lanes 3r..3r+2 by shuffles.
//   C. every thread: acc_w for every slot, the rotation table out, and
//      which intervals are exact identity steps.
//   D/E. warp 11 runs the position/velocity chain and the extrapolation,
//      while warps 0-10 run the covariance recursion under a named barrier
//      of their own (bar.sync 1, 352): per interval, build F in shared
//      memory, barrier, T = F cov, barrier, cov = T F^T + Q, each product
//      over F's nonzero terms (row_nnz). F alternates between two
//      buffers, so the next interval's F is written while this one's is
//      still read, and two barriers an interval suffice.
// An interval with dt = 0 whose F is the identity and Q zero (finite
// rate, acceleration and rotation) is a copy of the carry: F cov F^T + Q
// then equals cov exactly, so skipping it changes no bit. Likewise a
// rotation step whose Exp is exactly the identity is a copy. Padded slots
// still get every output the plain version writes (rot, pos, vel, acc_w,
// gyr_b), which undistort reads.
//
// The C entry point takes device pointers only (t_end and acc_scale too:
// no host read), launches on the caller's stream, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 18;             // error-state dimension
constexpr int kCov = kDim * kDim;    // covariance entries
constexpr int kThreads = 384;        // kCov rounded up to whole warps
constexpr int kCovThreads = 352;     // warps 0-10: the covariance recursion
constexpr int kChainWarp = 11;       // position/velocity chain and the tail
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps2 = 1e-8 * 1e-8;  // so3.exp's _EPS * _EPS

constexpr int kExpIdentity = 1;      // Exp(w dt) is exactly I
constexpr int kCovIdentity = 2;      // F = I and Q = 0 exactly

// Output layout, in elements of T: the new state, then the pose table.
constexpr int kOutRot = 0, kOutPos = 9, kOutVel = 12, kOutCov = 15;
constexpr int kOutState = kOutCov + kCov;  // 339

template <typename T, typename W>
struct Args {
  const T *rot, *pos, *vel, *bg, *ba, *grav, *cov;
  const W *stamps, *gyr, *acc, *t_end, *acc_scale;
  const unsigned char* mask;
  int m;
  T cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc;
  T* out;
};

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// so3.exp: the same branchless Rodrigues formula (row-major 3x3).
template <typename T>
__device__ void so3_exp(T x, T y, T z, T* e) {
  const T eps2 = T(kEps2);
  const T t2 = x * x + y * y + z * z;
  const T th = sqrt_(t2 + eps2);
  const bool small = t2 < T(1e-10);
  const T a = small ? T(1) - t2 / T(6) : sin_(th) / th;
  const T b = small ? T(0.5) - t2 / T(24) : (T(1) - cos_(th)) / (t2 + eps2);
  const T k[9] = {T(0), -z, y, z, T(0), -x, -y, x, T(0)};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T kk = k[3 * r] * k[c] + k[3 * r + 1] * k[3 + c] + k[3 * r + 2] * k[6 + c];
      e[3 * r + c] = (r == c ? T(1) : T(0)) + a * k[3 * r + c] + b * kk;
    }
}

// Entry (r, c) of the transition F of one interval: R = rot[i], e =
// Exp(w dt) (F's top-left block is Exp(-w dt) = e^T), a = acc_avg[i].
template <typename T>
__device__ T f_entry(int r, int c, T dt, const T* R, const T* e, const T* a) {
  if (r < 3) {
    if (c < 3) return e[3 * c + r];
    if (c >= 9 && c < 12) return c - 9 == r ? -dt : T(0);
  } else if (r < 6) {
    if (c >= 6 && c < 9) return c - 6 == r - 3 ? dt : T(0);
  } else if (r < 9) {
    const int rr = r - 6;
    if (c < 3) {  // -(R [a]x) dt, with column c of [a]x
      const T h0 = c == 0 ? T(0) : (c == 1 ? -a[2] : a[1]);
      const T h1 = c == 0 ? a[2] : (c == 1 ? T(0) : -a[0]);
      const T h2 = c == 0 ? -a[1] : (c == 1 ? a[0] : T(0));
      return -(R[3 * rr] * h0 + R[3 * rr + 1] * h1 + R[3 * rr + 2] * h2) * dt;
    }
    if (c >= 12 && c < 15) return -R[3 * rr + c - 12] * dt;
    if (c >= 15) return c - 15 == rr ? dt : T(0);
  }
  return r == c ? T(1) : T(0);
}

// F's row r has its nonzeros in row_nnz(r) columns, row_col(r, 0..) in
// ascending order: the identity's diagonal, the Exp(-w dt) block and -I dt
// in rows 0-2, I dt in rows 3-5, -(R [a]x) dt, -R dt and I dt in rows 6-8.
// A product over these terms alone sums the same values in the same order
// as the dense 18-term one, without its exact zero terms.
__device__ __forceinline__ int row_nnz(int r) { return r < 3 ? 4 : r < 6 ? 2 : r < 9 ? 8 : 1; }

__device__ __forceinline__ int row_col(int r, int j) {
  if (r < 3) return j < 3 ? j : 9 + r;
  if (r < 6) return j == 0 ? r : r + 3;
  if (r < 9) return j < 3 ? j : j == 3 ? r : j < 7 ? 8 + j : r + 9;
  return r;
}

// Entry (r, c) of the process noise Q of one interval.
template <typename T, typename W>
__device__ T q_entry(int r, int c, T dt, const T* R, const Args<T, W>& p) {
  const T dt2 = dt * dt;
  if (r < 3 && c < 3) return r == c ? p.cov_gyr * dt2 : T(0);
  if (r >= 6 && r < 9 && c >= 6 && c < 9) {  // R (cov_acc I) R^T dt^2
    const T* u = R + 3 * (r - 6);
    const T* v = R + 3 * (c - 6);
    return ((u[0] * p.cov_acc) * v[0] + (u[1] * p.cov_acc) * v[1] + (u[2] * p.cov_acc) * v[2]) * dt2;
  }
  if (r != c) return T(0);
  if (r >= 9 && r < 12) return p.cov_bias_gyr * dt2;
  if (r >= 12 && r < 15) return p.cov_bias_acc * dt2;
  return T(0);
}

__device__ __forceinline__ void cov_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCovThreads) : "memory");
}

template <typename T>
__device__ __forceinline__ bool all_finite(const T* x, int n) {
  bool ok = true;
  for (int j = 0; j < n; ++j) ok = ok && isfinite(x[j]);
  return ok;
}

template <typename T>
size_t shared_bytes(int m) {
  const int k = m - 1;
  return sizeof(T) * (size_t)(13 * k + 12 * m + 4 * kCov) + sizeof(int) * (size_t)k;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads, 1) imu_propagate_kernel(const Args<T, W> p) {
  const int tid = threadIdx.x;
  const int m = p.m, k = m - 1;
  T* out = p.out;
  T* const p_rot = out + kOutState;
  T* const p_pos = p_rot + 9 * m;
  T* const p_vel = p_pos + 3 * m;
  T* const p_acc = p_vel + 3 * m;
  T* const p_gyr = p_acc + 3 * m;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const s_exp = reinterpret_cast<T*>(smem);  // k x 9
  T* const s_a = s_exp + 9 * k;                  // k x 3, acc_avg
  T* const s_dt = s_a + 3 * k;                   // k
  T* const s_rot = s_dt + k;                     // m x 9
  T* const s_acc = s_rot + 9 * m;                // m x 3, acc_w
  T* const s_cov = s_acc + 3 * m;                // 18 x 18
  T* const s_t = s_cov + kCov;                   // F cov
  T* const s_f = s_t + kCov;                     // two F buffers
  int* const s_flag = reinterpret_cast<int*>(s_f + 2 * kCov);  // k

  // The mask's count, as the plain version's sum (no prefix assumed).
  int n_valid = 0;
  for (int base = 0; base < m; base += kThreads)
    n_valid += __syncthreads_count(base + tid < m && p.mask[base + tid] != 0);

  // A. Per interval: what does not depend on the carry.
  const W scale = *p.acc_scale;
  for (int i = tid; i < k; i += kThreads) {
    T dt = T(p.stamps[i + 1] - p.stamps[i]) * (p.mask[i + 1] ? T(1) : T(0));
    dt = dt < T(0) ? T(0) : dt;  // a NaN stays NaN, as torch.clamp keeps it
    T w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w[c] = T(W(0.5) * (p.gyr[3 * i + c] + p.gyr[3 * i + 3 + c])) - p.bg[c];
      s_a[3 * i + c] = T(W(0.5) * (p.acc[3 * i + c] + p.acc[3 * i + 3 + c]) * scale) - p.ba[c];
      p_gyr[3 * i + c] = w[c];
      if (i == k - 1) p_gyr[3 * k + c] = w[c];  // the last slot repeats the last interval's
    }
    s_dt[i] = dt;
    T* e = s_exp + 9 * i;
    so3_exp(w[0] * dt, w[1] * dt, w[2] * dt, e);
    bool ident = true;
#pragma unroll
    for (int j = 0; j < 9; ++j) ident = ident && e[j] == (j % 4 == 0 ? T(1) : T(0));
    s_flag[i] = ident ? kExpIdentity : 0;
  }
  __syncthreads();

  // B. The rotation chain in warp 0: lane 3r + c holds rot[r][c].
  if (tid < 32) {
    const int r = (tid / 3) % 3, c = tid % 3;
    T v = tid < 9 ? p.rot[tid] : T(0);
    if (tid < 9) s_rot[tid] = v;
    for (int i = 0; i < k; ++i) {
      if (!(s_flag[i] & kExpIdentity)) {
        const T* e = s_exp + 9 * i;
        const T x0 = __shfl_sync(kFull, v, 3 * r);
        const T x1 = __shfl_sync(kFull, v, 3 * r + 1);
        const T x2 = __shfl_sync(kFull, v, 3 * r + 2);
        v = x0 * e[c] + x1 * e[3 + c] + x2 * e[6 + c];
      }
      if (tid < 9) s_rot[9 * (i + 1) + tid] = v;
    }
  }
  __syncthreads();

  // C. acc_w of every slot, the rotation table out, the identity steps.
  for (int j = tid; j < 3 * m; j += kThreads) {
    const int s = j / 3, c = j % 3;
    const T* R = s_rot + 9 * s + 3 * c;
    const T* a = s_a + 3 * (s == 0 ? 0 : s - 1);
    const T v = (R[0] * a[0] + R[1] * a[1] + R[2] * a[2]) + p.grav[c];
    s_acc[j] = v;
    p_acc[j] = v;
  }
  for (int j = tid; j < 9 * m; j += kThreads) p_rot[j] = s_rot[j];
  for (int i = tid; i < k; i += kThreads)
    if ((s_flag[i] & kExpIdentity) && s_dt[i] == T(0) && all_finite(s_a + 3 * i, 3) &&
        all_finite(s_rot + 9 * i, 9))
      s_flag[i] |= kCovIdentity;
  __syncthreads();

  if (tid >= 32 * kChainWarp) {
    // D. Position and velocity (lane c < 3 holds component c), then the
    // extrapolation from the last valid sample to t_end.
    const int lane = tid - 32 * kChainWarp, c = lane % 3;
    T pp = p.pos[c], vv = p.vel[c];
    if (lane < 3) {
      p_pos[c] = pp;
      p_vel[c] = vv;
    }
    for (int i = 0; i < k; ++i) {
      const T dt = s_dt[i], aw = s_acc[3 * (i + 1) + c];
      pp = pp + vv * dt + (T(0.5) * aw) * (dt * dt);
      vv = vv + aw * dt;
      if (lane < 3) {
        p_pos[3 * (i + 1) + c] = pp;
        p_vel[3 * (i + 1) + c] = vv;
      }
    }
    __syncwarp();
    const int last = n_valid - 1 > 0 ? n_valid - 1 : 0;
    const int lm1 = last - 1 > 0 ? last - 1 : 0;
    const T dte = T(*p.t_end - p.stamps[last]);
    const T* g = p_gyr + 3 * lm1;
    T e[9];
    so3_exp(g[0] * dte, g[1] * dte, g[2] * dte, e);
    if (lane < 9) {
      const int r = lane / 3, cc = lane % 3;
      const T* R = s_rot + 9 * last + 3 * r;
      out[kOutRot + lane] = R[0] * e[cc] + R[1] * e[3 + cc] + R[2] * e[6 + cc];
    }
    if (lane < 3) {
      const T acc_l = s_acc[3 * (lm1 + 1) + c];
      const T pos_l = p_pos[3 * last + c], vel_l = p_vel[3 * last + c];
      out[kOutPos + c] = pos_l + vel_l * dte + ((T(0.5) * acc_l) * dte) * dte;
      out[kOutVel + c] = vel_l + acc_l * dte;
    }
  } else if (tid < kCovThreads) {
    // E. The covariance recursion: thread (r, c) owns entry r * 18 + c.
    const bool own = tid < kCov;
    const int r = tid / kDim, c = tid % kDim;
    if (own) s_cov[tid] = p.cov[tid];
    int buf = 0;
    for (int i = 0; i < k; ++i) {
      if (s_flag[i] & kCovIdentity) continue;  // the same for every thread
      const T dt = s_dt[i];
      const T* R = s_rot + 9 * i;
      T* f = s_f + buf * kCov;
      if (own) f[tid] = f_entry(r, c, dt, R, s_exp + 9 * i, s_a + 3 * i);
      cov_barrier();
      if (own) {
        T s = T(0);
        for (int j = 0; j < row_nnz(r); ++j) {
          const int q = row_col(r, j);
          s += f[r * kDim + q] * s_cov[q * kDim + c];
        }
        s_t[tid] = s;
      }
      cov_barrier();
      if (own) {
        T s = T(0);
        for (int j = 0; j < row_nnz(c); ++j) {
          const int q = row_col(c, j);
          s += s_t[r * kDim + q] * f[c * kDim + q];
        }
        s_cov[tid] = s + q_entry(r, c, dt, R, p);
      }
      buf ^= 1;  // the next F goes to the other buffer while this one is read
    }
    if (own) out[kOutCov + tid] = s_cov[tid];
  }
}

template <typename T, typename W>
int launch(const Args<T, W>& p, cudaStream_t stream) {
  const size_t bytes = shared_bytes<T>(p.m);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        imu_propagate_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  imu_propagate_kernel<T, W><<<1, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int run(const void* rot, const void* pos, const void* vel, const void* bg, const void* ba,
        const void* grav, const void* cov, const void* stamps, const void* gyr, const void* acc,
        const void* mask, const void* t_end, const void* acc_scale, int m, double cov_gyr,
        double cov_acc, double cov_bias_gyr, double cov_bias_acc, void* out, cudaStream_t stream) {
  const Args<T, W> p = {
      static_cast<const T*>(rot),      static_cast<const T*>(pos),
      static_cast<const T*>(vel),      static_cast<const T*>(bg),
      static_cast<const T*>(ba),       static_cast<const T*>(grav),
      static_cast<const T*>(cov),      static_cast<const W*>(stamps),
      static_cast<const W*>(gyr),      static_cast<const W*>(acc),
      static_cast<const W*>(t_end),    static_cast<const W*>(acc_scale),
      static_cast<const unsigned char*>(mask), m,
      T(cov_gyr),                      T(cov_acc),
      T(cov_bias_gyr),                 T(cov_bias_acc),
      static_cast<T*>(out)};
  return launch(p, stream);
}

}  // namespace

// kind: 0 float state and window, 1 double state and window, 2 double
// state with a float window. The state's rot, pos, vel, bg, ba, grav,
// cov; the window's stamps, gyr, acc, mask (bool bytes), t_end and
// acc_scale (0-d); the four noise densities; out: 339 + 21 m elements of
// the state's type. Every pointer is device memory. Returns a cudaError_t.
extern "C" int imu_propagate(int kind, const void* rot, const void* pos, const void* vel,
                             const void* bg, const void* ba, const void* grav, const void* cov,
                             const void* stamps, const void* gyr, const void* acc,
                             const void* mask, const void* t_end, const void* acc_scale, int m,
                             double cov_gyr, double cov_acc, double cov_bias_gyr,
                             double cov_bias_acc, void* out, void* stream) {
  if (m < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IMU_RUN(T, W)                                                                          \
  run<T, W>(rot, pos, vel, bg, ba, grav, cov, stamps, gyr, acc, mask, t_end, acc_scale, m, \
            cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc, out, s)
  switch (kind) {
    case 0: return IMU_RUN(float, float);
    case 1: return IMU_RUN(double, double);
    case 2: return IMU_RUN(double, float);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IMU_RUN
}
