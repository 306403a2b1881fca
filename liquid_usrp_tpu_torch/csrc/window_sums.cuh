// Sliding windows of any length, for the generic geometries of kernels B2
// (detect_candidates.cu) and B3 (autocorr_metric.cu).
//
// A window of L terms starting at offset m is split at the multiples of L
// (van Herk / Gil-Werman with blocks of the window's own length): with
// b = m / L,
//
//   W[m] = S_b[m] + P_{b+1}[m + L - 1]   (m not a multiple of L)
//   W[m] = S_b[m]                        (m a multiple of L)
//
// where S_b is the suffix inside block b (terms m .. (b+1)L - 1) and P_{b+1}
// the prefix inside block b + 1 (terms (b+1)L .. m + L - 1).  Both parts
// hold only the window's own terms: a sum has no subtraction, so a loud
// burst leaves no residue in the windows of the quiet samples after it, and
// a max (the NMS) takes the same form and is exact.
//
// Nothing bounds L or the halo: one warp owns one (row, block b).  It walks
// block b backwards in steps of 32 terms (a warp suffix scan plus the carry
// of the steps after it), storing S_b at each output, then block b + 1
// forwards (a warp prefix scan plus carry), combining P_{b+1} into the
// stored value in place.  Each term is made twice (by the warps of blocks b
// and b - 1) from reads that L1 and L2 serve; nothing is staged in shared
// memory, so any L runs with the same resources.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define WS_THREADS 256

template <int N>
struct WsVec {
  float v[N];
};

// Sums (MAX false) or maxima (MAX true) of N planes at once.
template <int N, bool MAX>
struct WsOp {
  __device__ static WsVec<N> identity() {
    WsVec<N> r;
#pragma unroll
    for (int k = 0; k < N; ++k) r.v[k] = MAX ? -INFINITY : 0.f;
    return r;
  }
  // a holds the earlier terms, b the later ones
  __device__ static WsVec<N> comb(const WsVec<N>& a, const WsVec<N>& b) {
    WsVec<N> r;
#pragma unroll
    for (int k = 0; k < N; ++k)
      r.v[k] = MAX ? fmaxf(a.v[k], b.v[k]) : a.v[k] + b.v[k];
    return r;
  }
};

template <int N>
__device__ inline WsVec<N> ws_shfl_up(const WsVec<N>& a, int d) {
  WsVec<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = __shfl_up_sync(0xffffffffu, a.v[k], d);
  return r;
}

template <int N>
__device__ inline WsVec<N> ws_shfl_down(const WsVec<N>& a, int d) {
  WsVec<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k)
    r.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], d);
  return r;
}

template <int N>
__device__ inline WsVec<N> ws_shfl(const WsVec<N>& a, int lane) {
  WsVec<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = __shfl_sync(0xffffffffu, a.v[k], lane);
  return r;
}

// The windows W[m] of one row for m in [b L, min((b + 1) L, n_w)), by the
// calling warp (all 32 lanes, lane = threadIdx.x % 32).  Access supplies
//   WsVec<N> term(long long i)   the i-th term (any i >= 0: a term past the
//                                data serves no window that is kept)
//   void put(long long m, v)     store a partial window (S_b)
//   WsVec<N> get(long long m)    read it back
//   void done(long long m, v)    the finished window
template <int N, bool MAX, class Access>
__device__ void ws_block(Access& acc, long long b, int L, long long n_w,
                         int lane) {
  typedef WsOp<N, MAX> Op;
  const long long m0 = b * L;
  const long long rest = n_w - m0;
  const int nb = rest < L ? (int)rest : L;  // windows of this block
  // block b backwards: S_b[m0 + p] for p < nb
  WsVec<N> carry = Op::identity();
  for (int base = (L - 1) & ~31; base >= 0; base -= 32) {
    const int p = base + lane;
    WsVec<N> v = p < L ? acc.term(m0 + p) : Op::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const WsVec<N> t = ws_shfl_down(v, d);
      if (lane + d < 32) v = Op::comb(v, t);
    }
    const WsVec<N> s = Op::comb(v, carry);
    if (p < nb) {
      if (p == 0)
        acc.done(m0, s);
      else
        acc.put(m0 + p, s);
    }
    carry = ws_shfl(s, 0);
  }
  __syncwarp();  // the stores above are read back by other lanes below
  // block b + 1 forwards: W[m0 + q + 1] = S_b[m0 + q + 1] + P_{b+1}[q]
  carry = Op::identity();
  for (int base = 0; base < nb - 1; base += 32) {
    const int q = base + lane;
    WsVec<N> v = q < nb - 1 ? acc.term(m0 + L + q) : Op::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const WsVec<N> t = ws_shfl_up(v, d);
      if (lane >= d) v = Op::comb(t, v);
    }
    const WsVec<N> s = Op::comb(carry, v);
    if (q < nb - 1) acc.done(m0 + q + 1, Op::comb(acc.get(m0 + q + 1), s));
    carry = ws_shfl(s, 31);
  }
}

// The warp of this thread, as (row, block) of rows x nblk; false for the
// warps past the last (whole warps, so the shuffles stay full).
__device__ inline bool ws_warp(long long rows, long long nblk, long long* row,
                               long long* b) {
  const long long w =
      ((long long)blockIdx.x * WS_THREADS + threadIdx.x) >> 5;
  if (w >= rows * nblk) return false;
  *row = w / nblk;
  *b = w - *row * nblk;
  return true;
}

static long long ws_grid(long long rows, long long nblk) {
  return (rows * nblk * 32 + WS_THREADS - 1) / WS_THREADS;
}

// The lag-product terms of a row of complex samples (the Schmidl-Cox
// sums): Re and Im of x[i] conj(x[i + lag]) and |x[i]|^2, reading the
// last sample past the row end.
__device__ inline WsVec<3> ws_lag_term(const float2* __restrict__ rp,
                                       int len, int lag, long long i) {
  const float2 a = rp[i < len ? i : len - 1];
  const long long j = i + lag;
  const float2 c = rp[j < len ? j : len - 1];
  WsVec<3> r;
  r.v[0] = a.x * c.x + a.y * c.y;
  r.v[1] = a.y * c.x - a.x * c.y;
  r.v[2] = a.x * a.x + a.y * a.y;
  return r;
}

// Window sums of the lag products over span terms: c (float2) at offsets
// below n_c and e1 at offsets below n_c + lag, per row.
struct WsLagSums {
  const float2* __restrict__ rp;
  int len, lag;
  long long n_c;
  float2* c;   // this row's [n_c]
  float* e1;   // this row's [n_c + lag]
  __device__ WsVec<3> term(long long i) const {
    return ws_lag_term(rp, len, lag, i);
  }
  __device__ void put(long long m, const WsVec<3>& v) {
    if (m < n_c) c[m] = make_float2(v.v[0], v.v[1]);
    e1[m] = v.v[2];
  }
  __device__ WsVec<3> get(long long m) const {
    WsVec<3> r;
    const float2 cv = m < n_c ? c[m] : make_float2(0.f, 0.f);
    r.v[0] = cv.x;
    r.v[1] = cv.y;
    r.v[2] = e1[m];
    return r;
  }
  __device__ void done(long long m, const WsVec<3>& v) { put(m, v); }
};

static __global__ void __launch_bounds__(WS_THREADS)
ws_lag_sums_kernel(const float2* __restrict__ ext, long long rows, int len,
                   int lag, int span, long long n_c, long long nblk,
                   float2* __restrict__ c, float* __restrict__ e1) {
  long long row, b;
  if (!ws_warp(rows, nblk, &row, &b)) return;
  WsLagSums acc{ext + row * len, len, lag, n_c, c + row * n_c,
                e1 + row * (n_c + lag)};
  ws_block<3, false>(acc, b, span, n_c + lag, threadIdx.x & 31);
}

// Launches ws_lag_sums_kernel: c [rows, n_c] and e1 [rows, n_c + lag] of
// ext [rows, len], with n_c + lag + span - 1 <= len.
static cudaError_t ws_lag_sums(const float2* ext, long long rows, int len,
                               int lag, int span, long long n_c, float2* c,
                               float* e1, cudaStream_t st) {
  const long long nblk = (n_c + lag + span - 1) / span;
  const long long grid = ws_grid(rows, nblk);
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  ws_lag_sums_kernel<<<(unsigned)grid, WS_THREADS, 0, st>>>(
      ext, rows, len, lag, span, n_c, nblk, c, e1);
  return cudaGetLastError();
}

// The floor-gated Schmidl-Cox metric from the window sums, as the plain
// version computes it.
__device__ inline float ws_metric(float2 c, float e1, float e2,
                                  float floor_v) {
  const float c2 = c.x * c.x + c.y * c.y;
  return fminf(e1, e2) > floor_v ? c2 / fmaxf(e1 * e2, 1e-12f) : 0.f;
}
