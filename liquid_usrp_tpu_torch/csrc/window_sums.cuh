// Window sums of any length, for the generic geometries of kernels B2
// (detect_candidates.cu) and B3 (autocorr_metric.cu): the chunk totals and
// the tile scans that both form, so that both sum the same terms the same
// way.
//
// A window of span terms starting at offset n = b*span + q splits at the
// multiples of span (van Herk / Gil-Werman with blocks of the window's own
// length): it is the suffix of block b from q plus the prefix of block
// b + 1 up to q - 1, for the four planes Re and Im of x[i] conj(x[i + lag]),
// |x[i]|^2 and |x[i + lag]|^2 (c, e1 and e2 at once, so e2 needs no second
// read of an e1 plane).  A block is cut into nch chunks of ch terms (the
// last one shorter).  w3_totals_kernel sums each chunk (one CUDA block a
// chunk, a fixed tree) into 16 bytes of scratch.  A tile is one chunk of
// outputs of one block: w3_stage_tile stages the chunk's samples of blocks
// b and b + 1 with their lag partners (samples [n0, n0 + h) and [n0 + lag,
// n0 + lag + nl) for a chunk of nl terms at n0, h = min(lag, nl): one run
// when lag < nl, at most 2 W3_CH samples a block whatever the lag) and the
// two blocks' chunk totals in shared memory; w3_window_sums forms the
// terms there, scans them (a suffix
// scan in block b, an exclusive prefix scan in block b + 1: per thread,
// across lanes by shuffles, across warps from shared memory) and adds the
// totals of the chunks between (later chunks of block b, earlier ones of
// block b + 1, in a fixed order).  Every window is a sum of its own terms
// only, with no subtraction, so a loud burst leaves no residue in the
// quiet samples after it; no sum depends on timing.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define W3_R 7                       // terms per thread (odd: no conflicts)
#define W3_THREADS 128
#define W3_CH (W3_R * W3_THREADS)    // most terms of a chunk, outputs of a tile
#define W3_WARPS (W3_THREADS / 32)

// The floor-gated Schmidl-Cox metric from the window sums, as the plain
// version computes it.
__device__ inline float ws_metric(float2 c, float e1, float e2,
                                  float floor_v) {
  const float c2 = c.x * c.x + c.y * c.y;
  return fminf(e1, e2) > floor_v ? c2 / fmaxf(e1 * e2, 1e-12f) : 0.f;
}

// Re and Im of a * conj(b), |a|^2, |b|^2.
__device__ inline void w3_term(float2 a, float2 b, float* v) {
  v[0] = a.x * b.x + a.y * b.y;
  v[1] = a.y * b.x - a.x * b.y;
  v[2] = a.x * a.x + a.y * a.y;
  v[3] = b.x * b.x + b.y * b.y;
}

// Sample i of a row, repeating the last one past the row end.
__device__ inline float2 w3_x(const float2* __restrict__ rp, int len,
                              long long i) {
  return rp[i < len ? i : len - 1];
}

// dst[i] = sample n0 + i of the row for i < n, by 8-byte cp.async copies
// (the last sample past the row end), all in flight at once.
__device__ inline void w3_stage(float2* dst, const float2* __restrict__ rp,
                                int len, long long n0, int n) {
  for (int i = threadIdx.x; i < n; i += W3_THREADS) {
    const long long gi = n0 + i;
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(rp + (gi < len ? gi : len - 1))
                 : "memory");
  }
}

// Chunk totals: tot[(row * nbt + b) * nch + k] for every block b < nbt
// (one more than the blocks holding outputs: their windows reach it), one
// block a chunk of ch <= W3_CH terms (CH > 0: ch is the constant CH).
template <int CH>
static __global__ void __launch_bounds__(W3_THREADS)
w3_totals_kernel(const float2* __restrict__ ext, int len, int lag, int span,
                 int ch_rt, int nch, int nbt, float4* __restrict__ tot) {
  __shared__ float red[4][W3_WARPS];
  const int ch = CH ? CH : ch_rt;
  const unsigned w = blockIdx.x;  // < 2^31 (the launch checks)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = (int)(w % (unsigned)nch);
  const unsigned rb = w / (unsigned)nch;
  const int b = (int)(rb % (unsigned)nbt);
  const long long row = rb / (unsigned)nbt;
  const long long s0 = (long long)b * span + (long long)k * ch;
  const int n = min(ch, span - k * ch);
  const float2* rp = ext + row * len;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < W3_R; ++r) {
    const int i = r * W3_THREADS + tid;
    if (i < n) {
      float v[4];
      w3_term(w3_x(rp, len, s0 + i), w3_x(rp, len, s0 + i + lag), v);
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[p] += v[p];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
#pragma unroll
    for (int p = 0; p < 4; ++p)
      acc[p] += __shfl_down_sync(0xffffffffu, acc[p], d);
  if (lane == 0)
#pragma unroll
    for (int p = 0; p < 4; ++p) red[p][warp] = acc[p];
  __syncthreads();
  if (tid == 0) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < W3_WARPS; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) t[p] += red[p][q];
    tot[w] = make_float4(t[0], t[1], t[2], t[3]);
  }
}

// One tile: outputs b*span + k*ch + [0, nl) (inside block b) of one row;
// tile = (row * nblk + b) * nch + k < 2^31 (the launch checks), so its
// index splits by 32-bit division.
struct W3Tile {
  long long row, n0;  // the row, its first output
  int b, k, nl;       // the block, the chunk, the chunk's terms
};

__device__ inline W3Tile w3_tile(unsigned tile, int span, int ch, int nch,
                                 int nblk) {
  W3Tile t;
  t.k = (int)(tile % (unsigned)nch);
  const unsigned rb = tile / (unsigned)nch;
  t.b = (int)(rb % (unsigned)nblk);
  t.row = rb / (unsigned)nblk;
  t.n0 = (long long)t.b * span + (long long)t.k * ch;
  t.nl = min(ch, span - t.k * ch);
  return t;
}

// Shared-memory float2 slots of one block's samples in a staging buffer:
// a chunk and its lag partners.
__host__ __device__ inline int w3_half(int lag) {
  return W3_CH + (lag < W3_CH ? lag : W3_CH);
}

// Shared-memory float2 slots of one staging buffer: the samples of block
// b's chunk k and of block b + 1's chunk k, each with its lag partners,
// then the chunk totals of blocks b and b + 1 (2 nch float4).
__host__ __device__ inline int w3_buf(int lag, int nch) {
  return 2 * w3_half(lag) + 4 * nch;
}

// Issues the copies of a tile's samples and chunk totals into ``buf``
// (no totals when a block is one chunk: its windows read none): per block,
// its samples [n0, n0 + h) and then [n0 + lag, n0 + lag + nl), h =
// min(lag, nl), so that term i reads slots i and i + h (one run of nl +
// lag samples when lag <= nl).
__device__ inline void w3_stage_tile(float2* buf, const W3Tile& t,
                                     const float2* __restrict__ ext, int len,
                                     int lag, int span, int nch, int nblk,
                                     const float4* __restrict__ tot) {
  const float2* rp = ext + t.row * len;
  const int half = w3_half(lag);
  if (lag <= t.nl) {
    w3_stage(buf, rp, len, t.n0, t.nl + lag);
    w3_stage(buf + half, rp, len, t.n0 + span, t.nl + lag);
  } else {
    w3_stage(buf, rp, len, t.n0, t.nl);
    w3_stage(buf + t.nl, rp, len, t.n0 + lag, t.nl);
    w3_stage(buf + half, rp, len, t.n0 + span, t.nl);
    w3_stage(buf + half + t.nl, rp, len, t.n0 + span + lag, t.nl);
  }
  if (nch == 1) return;
  float4* ts = reinterpret_cast<float4*>(buf + 2 * half);
  const float4* tc = tot + (t.row * (nblk + 1) + t.b) * nch;
  for (int i = threadIdx.x; i < 2 * nch; i += W3_THREADS) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(ts + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(tc + i)
                 : "memory");
  }
}

// The windows of the tile's outputs i = threadIdx.x * W3_R + r, each
// handed to out(r, w) (w: Re c, Im c, e1, e2), from its staged buffer
// ``buf`` (chunk k of nch, nl terms) and ``wt``, 8 W3_WARPS floats of
// shared memory.  Every thread of the block calls it; out runs past a
// barrier that follows every read of the staged samples, so it may
// overwrite them.  Outputs i >= nl get values that no output reads.
template <class Out>
__device__ inline void w3_window_sums(const float2* buf, int lag, int nch,
                                      int k, int nl, float* wt, Out&& out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = min(lag, nl), half = w3_half(lag);
  const float2* XA = buf;                 // block b:     n0 + ...
  const float2* XB = XA + half;           // block b + 1: n0 + span + ...
  const float4* ts = reinterpret_cast<const float4*>(XB + half);

  // 1. The chunks between: later chunks of block b, earlier ones of b + 1.
  float tsuf[4] = {0.f, 0.f, 0.f, 0.f}, tpre[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kk = nch - 1; kk > k; --kk) {
    const float4 v = ts[kk];
    tsuf[0] += v.x; tsuf[1] += v.y; tsuf[2] += v.z; tsuf[3] += v.w;
  }
  for (int kk = 0; kk < k; ++kk) {
    const float4 v = ts[nch + kk];
    tpre[0] += v.x; tpre[1] += v.y; tpre[2] += v.z; tpre[3] += v.w;
  }

  // 2. Own terms i = tid * W3_R + r: in-thread suffix sums of block b's
  //    (sa), exclusive prefix sums of block b + 1's (pb).
  float sa[W3_R][4], pb[W3_R][4], ta[4], tb[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) ta[p] = tb[p] = 0.f;
#pragma unroll
  for (int r = W3_R - 1; r >= 0; --r) {
    const int i = tid * W3_R + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < nl) w3_term(XA[i], XA[i + h], v);
#pragma unroll
    for (int p = 0; p < 4; ++p) sa[r][p] = ta[p] = v[p] + ta[p];
  }
#pragma unroll
  for (int r = 0; r < W3_R; ++r) {
    const int i = tid * W3_R + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < nl) w3_term(XB[i], XB[i + h], v);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      pb[r][p] = tb[p];
      tb[p] += v[p];
    }
  }
  // across lanes: inclusive scans of the thread totals, then shifted by
  // one lane (the lanes after / before this one)
  float la[4], lb[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float sv = ta[p], qv = tb[p];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, sv, d);
      const float q2 = __shfl_up_sync(0xffffffffu, qv, d);
      if (lane + d < 32) sv += s2;
      if (lane >= d) qv = q2 + qv;
    }
    if (lane == 0) wt[p * W3_WARPS + warp] = sv;  // warp totals
    if (lane == 31) wt[(4 + p) * W3_WARPS + warp] = qv;
    const float s1 = __shfl_down_sync(0xffffffffu, sv, 1);
    const float q1 = __shfl_up_sync(0xffffffffu, qv, 1);
    la[p] = lane < 31 ? s1 : 0.f;
    lb[p] = lane > 0 ? q1 : 0.f;
  }
  __syncthreads();
  // across warps, in a fixed order (every total read at once; the
  // ones after / before this warp added)
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float wb = 0.f;
#pragma unroll
    for (int w = W3_WARPS - 1; w >= 0; --w) {
      const float v = wt[p * W3_WARPS + w];
      if (w > warp) la[p] += v;
    }
#pragma unroll
    for (int w = 0; w < W3_WARPS; ++w) {
      const float v = wt[(4 + p) * W3_WARPS + w];
      if (w < warp) wb += v;
    }
    lb[p] = wb + lb[p];
  }

  // 3. The windows.
#pragma unroll
  for (int r = 0; r < W3_R; ++r) {
    float wv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      wv[p] =
          ((sa[r][p] + la[p]) + tsuf[p]) + (tpre[p] + (lb[p] + pb[r][p]));
    out(r, wv);
  }
}

// Lets a kernel take ``smem`` bytes of dynamic shared memory (at most
// 227 KB).
static cudaError_t w3_smem_attr(const void* kern, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The persistent grid of a tile kernel of W3_THREADS threads and ``smem``
// bytes of shared memory: the blocks all SMs hold at once (occupancy
// query), at most one a tile.
static cudaError_t w3_persistent_grid(const void* kern, size_t smem,
                                      long long tiles, long long* grid) {
  cudaError_t err = w3_smem_attr(kern, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        W3_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  return cudaSuccess;
}
