// S0 periodicity (Schmidl-Cox) metric and lag correlation (kernel B3).
//
// Replaces the TPU kernel liquid_usrp_tpu/ops/pallas_kernels.py ::
// detect_metric_onepass (body _detect1p_kernel).  For every offset n < n_out
// = len - span - lag + 1 of every row:
//
//   c[n]  = sum_{i<span} x[n+i] * conj(x[n+i+lag])
//   e1[n] = sum_{i<span} |x[n+i]|^2,   e2[n] = e1[n+lag]
//   metric[n] = |c|^2 / max(e1*e2, 1e-12), or 0 unless min(e1, e2) > floor
//
// It writes the full-rate metric (float) and c (interleaved float2, a
// complex64 tensor on the host side).  The floor per row is computed by the
// wrapper (ops/kernels.py), as the JAX wrapper computes it.  Beyond the row
// end the stream repeats its last sample, as the JAX wrapper pads; no valid
// output reads it.
//
// What bounds it on the card: device-memory traffic, 8 B read and 12 B
// written per output (the stores are 60 % of the bytes).  The design keeps
// the on-chip work per output small and constant, and keeps the memory busy
// while the SMs compute:
//
// * Window sums in the chunked van Herk / Gil-Werman form of kernel B2
//   (detect_candidates.cu): each thread owns a chunk of B3_R consecutive
//   offsets; a window of span terms is the suffix sum of its first chunk
//   (registers), the totals of the chunks in between and the prefix sum of
//   its last chunk (shared memory).  About 16 shared-memory accesses per
//   output, whatever the span, where a direct sum takes 4 per term.  Every
//   window is a sum of its own terms only, with no subtraction: the quiet
//   samples after a loud burst are outputs themselves, and a float32
//   running sum would leave the burst's residue in them.
// * e2[n] = e1[n + lag] is a read of the e1 plane, not a fourth sum.
// * B3_R is odd: lanes that read at a stride of B3_R words (or float2) hit
//   distinct banks.
// * A persistent grid: the blocks an SM holds (occupancy query, at most
//   B3_BLOCKS_PER_SM) walk the (row, tile) pairs with a grid stride, and
//   the samples of a block's next tile are in flight (16-byte cp.async into
//   the second of two staging buffers) while it sums and stores this one.
//   Three blocks of 256 threads an SM measured fastest (scripts/
//   kernel_variants.py, NVIDIA H100 80GB HBM3 at a 700.00 W power limit):
//   at the single-channel path's 368 tiles (8 rows of 100,366 samples)
//   each of the 396 blocks takes one tile, and loads, sums and stores
//   overlap across the three blocks of an SM; two blocks an SM, each
//   walking one or two tiles, took 27-60 % longer (four runs).
// * Coalesced 16-byte stores: the tile's metric and c are staged in shared
//   memory at the alignment of their place in the output, then written as
//   float4 (4 metrics, or 2 c); each row's unaligned head and tail go out as
//   scalars (n_out is odd at the single-channel shapes).
// * The geometry of M = 48 is a template instance, so its loops unroll with
//   constant bounds; every other geometry that the kernel takes runs the
//   generic instance.
//
// The tile must hold span + lag offsets and span must exceed B3_R, so this
// kernel takes span + lag <= B3_CAP - 3 (OFDM M up to 1,150) and span > 9.
// Any other geometry runs the window-sum path at the end of this file.
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_sums.cuh"

#define B3_R 9                // offsets per thread chunk (odd)
#define B3_BLOCKS_PER_SM 3    // resident blocks an SM takes at most
#define B3_THREADS 256        // one chunk per thread
#define B3_CAP (B3_R * B3_THREADS)

// Outputs of one tile: the most whose windows (span lag products for c,
// span powers at offsets up to lag further for e1 and e2) lie in the
// block's B3_CAP offsets; a multiple of 4.
__host__ __device__ constexpr int b3_tile(int lag, int span) {
  return (B3_CAP - lag - span + 1) & ~3;
}

// float2 slots of one staging buffer: B3_CAP + lag samples, the pair parity
// shift and the rounding to pairs; even, so that each buffer is 16-byte
// aligned.
__host__ __device__ constexpr int b3_xs(int lag) {
  return (B3_CAP + lag + 3) & ~1;
}

// Shared-memory floats of one block: two staging buffers (the current one
// later holds e1), 3 planes of in-chunk prefix sums (later the staged
// metric and c) with a pad of span floats, and 3 planes of chunk totals
// with a pad of K + 1 floats.  Every thread computes all B3_R offsets of its
// chunk with no bounds test: offsets past the tile give values no output
// reads, and the pads keep their reads inside the block's memory.
__host__ __device__ constexpr int b3_smem_floats(int lag, int span) {
  return 4 * b3_xs(lag) + 3 * B3_CAP + span + 3 * B3_THREADS +
         (span - 1) / B3_R + 1;
}

// Issues the copies of samples [n0, n0 + B3_CAP + lag) of the row at
// ``roff`` into ``xs`` (sample n0 + i at xs[s + i], s the pair parity):
// 16-byte cp.async for pairs inside the row when the tensor is aligned,
// else plain loads, with the last sample repeated past the row end.
__device__ inline void b3_stage(float2* xs, const float2* __restrict__ ext,
                                long long roff, int len, int n0, int lag,
                                bool vec) {
  const float2* rp = ext + roff;
  const int s = (int)((roff + n0) & 1);
  const int npair = (B3_CAP + lag + s + 1) >> 1;
  for (int p = threadIdx.x; p < npair; p += B3_THREADS) {
    const int gi = n0 - s + 2 * p;
    if (vec && gi >= 0 && gi + 1 < len) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(xs + 2 * p);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(rp + gi)
                   : "memory");
    } else {
      const int g0 = gi < 0 ? 0 : (gi < len ? gi : len - 1);
      const int g1 = gi + 1 < len ? gi + 1 : len - 1;
      xs[2 * p] = rp[g0];
      xs[2 * p + 1] = rp[g1];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// LAG, SPAN > 0: the detect geometry as compile-time constants (M = 48), so
// every loop unrolls with constant bounds; 0, 0: the same kernel for any
// geometry, from lag_rt and span_rt.
template <int LAG, int SPAN>
__global__ void __launch_bounds__(B3_THREADS, B3_BLOCKS_PER_SM)
autocorr_metric_kernel(const float2* __restrict__ ext, int rows, int len,
                       int lag_rt, int span_rt,
                       const float* __restrict__ floors, int n_out,
                       float* __restrict__ metric, float2* __restrict__ c) {
  extern __shared__ __align__(16) float sm[];
  const int lag = LAG ? LAG : lag_rt;
  const int span = SPAN ? SPAN : span_rt;
  const int TO = b3_tile(lag, span);
  const int nt = B3_THREADS;
  const int cap = B3_CAP;
  const int XB = b3_xs(lag);
  float* pre = sm + 4 * XB;         // 3 planes of cap, then a pad
  float* csum = pre + 3 * cap + span;  // 3 planes of nt, then a pad
  float* mst = pre;                 // staged metric, cap + 4
  float2* cst = reinterpret_cast<float2*>(pre + cap + 4);  // staged c
  const int tid = threadIdx.x;
  const int tiles = (n_out + TO - 1) / TO;
  const int items = rows * tiles;
  const bool vin = ((uintptr_t)ext & 15) == 0;
  int it = blockIdx.x;  // < items: the grid holds at most one block a tile
  {
    const int row = it / tiles;
    b3_stage(reinterpret_cast<float2*>(sm), ext, (long long)row * len, len,
             (it - row * tiles) * TO, lag, vin);
  }

  for (int buf = 0; it < items; it += gridDim.x, buf ^= 1) {
    const int row = it / tiles;
    const int n0 = (it - row * tiles) * TO;
    float2* xs = reinterpret_cast<float2*>(sm) + buf * XB;

    // 1. The next tile's copies into the other buffer (free since the
    //    barrier before the last stores), then wait for this tile's.
    const int nxt = it + gridDim.x;
    if (nxt < items) {
      const int nrow = nxt / tiles;
      b3_stage(reinterpret_cast<float2*>(sm) + (buf ^ 1) * XB, ext,
               (long long)nrow * len, len, (nxt - nrow * tiles) * TO, lag,
               vin);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    // 2. Lag products of the own chunk: in-chunk prefix sums to shared
    //    memory, chunk totals, in-chunk suffix sums kept in registers.
    const float2* X = xs + (int)(((long long)row * len + n0) & 1);
    const int q0 = tid * B3_R;
    float sr[B3_R], si[B3_R], sp[B3_R];
    {
      float ar = 0.f, ai = 0.f, ap = 0.f;
#pragma unroll
      for (int r = 0; r < B3_R; ++r) {
        const float2 a = X[q0 + r], b = X[q0 + r + lag];  // a * conj(b)
        sr[r] = a.x * b.x + a.y * b.y;
        si[r] = a.y * b.x - a.x * b.y;
        sp[r] = a.x * a.x + a.y * a.y;
        ar += sr[r];
        ai += si[r];
        ap += sp[r];
        pre[q0 + r] = ar;
        pre[cap + q0 + r] = ai;
        pre[2 * cap + q0 + r] = ap;
      }
      csum[tid] = ar;
      csum[nt + tid] = ai;
      csum[2 * nt + tid] = ap;
#pragma unroll
      for (int r = B3_R - 2; r >= 0; --r) {
        sr[r] += sr[r + 1];
        si[r] += si[r + 1];
        sp[r] += sp[r + 1];
      }
    }
    __syncthreads();

    // 3. Window sums of the own offsets q = q0 + r: the suffix sum of the
    //    own chunk, the totals of chunks tid+1 .. tid+K-1, then the prefix
    //    of the chunk holding the window end; from r = rs on, that chunk is
    //    tid+K+1 and chunk tid+K counts whole.  c stays in registers; e1
    //    goes to shared memory (over the staged samples) for e2.
    float* e1s = reinterpret_cast<float*>(xs);
    float cr[B3_R], ci[B3_R], e1[B3_R];
    {
      const int K = (span - 1) / B3_R;
      const int rs = B3_R * (K + 1) - span + 1;
      float mr = 0.f, mi = 0.f, mp = 0.f;
#pragma unroll
      for (int k = 1; k < K; ++k) {
        mr += csum[tid + k];
        mi += csum[nt + tid + k];
        mp += csum[2 * nt + tid + k];
      }
      const float mr1 = mr + csum[tid + K];
      const float mi1 = mi + csum[nt + tid + K];
      const float mp1 = mp + csum[2 * nt + tid + K];
#pragma unroll
      for (int r = 0; r < B3_R; ++r) {
        const int e = q0 + r + span - 1;
        cr[r] = (sr[r] + (r < rs ? mr : mr1)) + pre[e];
        ci[r] = (si[r] + (r < rs ? mi : mi1)) + pre[cap + e];
        e1[r] = (sp[r] + (r < rs ? mp : mp1)) + pre[2 * cap + e];
        e1s[q0 + r] = e1[r];
      }
    }
    __syncthreads();

    // 4. The floor-gated metric of the own offsets; metric and c staged
    //    (over the prefix planes) at the alignment of their output places.
    const long long G = (long long)row * n_out + n0;  // output 0 of the tile
    const int a4 = (int)(G & 3), a2 = (int)(G & 1);
    {
      const float floor_v = floors[row];
#pragma unroll
      for (int r = 0; r < B3_R; ++r) {
        const float e2 = e1s[q0 + r + lag];
        const float c2 = cr[r] * cr[r] + ci[r] * ci[r];
        mst[q0 + r + a4] = (fminf(e1[r], e2) > floor_v)
                               ? c2 / fmaxf(e1[r] * e2, 1e-12f)
                               : 0.f;
        cst[q0 + r + a2] = make_float2(cr[r], ci[r]);
      }
    }
    __syncthreads();

    // 5. Stores of the tile's nv outputs: a scalar head up to the 16-byte
    //    boundary, float4 in between, a scalar tail.
    const int nv = min(TO, n_out - n0);
    float* mrow = metric + G;
    float2* crow = c + G;
    const int h4 = min(nv, (4 - a4) & 3);
    const int n4 = (nv - h4) >> 2;
    const int h2 = min(nv, a2);
    const int n2 = (nv - h2) >> 1;
    {
      const float4* src = reinterpret_cast<const float4*>(mst + h4 + a4);
      float4* dst = reinterpret_cast<float4*>(mrow + h4);
      for (int k = tid; k < n4; k += nt) dst[k] = src[k];
    }
    {
      const float4* src = reinterpret_cast<const float4*>(cst + h2 + a2);
      float4* dst = reinterpret_cast<float4*>(crow + h2);
      for (int k = tid; k < n2; k += nt) dst[k] = src[k];
    }
    for (int j = tid; j < h4; j += nt) mrow[j] = mst[j + a4];
    for (int j = h4 + 4 * n4 + tid; j < nv; j += nt) mrow[j] = mst[j + a4];
    for (int j = tid; j < h2; j += nt) crow[j] = cst[j + a2];
    for (int j = h2 + 2 * n2 + tid; j < nv; j += nt) crow[j] = cst[j + a2];
  }
}

typedef void (*MetricKernel)(const float2*, int, int, int, int, const float*,
                             int, float*, float2*);

// Whether the persistent kernel above takes the geometry: B3_R < span and a
// tile of at least 4 outputs.
static bool metric_one_pass(int lag, int span) {
  return span > B3_R && b3_tile(lag, span) >= 4;
}

// The instantiation for a geometry: M = 48, the one the paths run, else
// the generic one.
static MetricKernel metric_kernel(int lag, int span) {
  if (lag == 12 && span == 84) return autocorr_metric_kernel<12, 84>;
  return autocorr_metric_kernel<0, 0>;
}

static int metric_launch_one_pass(const float2* ext, int rows, int len,
                                  int lag, int span, const float* floors,
                                  int n_out, float* metric, float2* c,
                                  cudaStream_t st) {
  if ((((uintptr_t)metric | (uintptr_t)c) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int TO = b3_tile(lag, span);
  const long long items = (long long)rows * ((n_out + TO - 1) / TO);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)b3_smem_floats(lag, span);
  const MetricKernel kern = metric_kernel(lag, span);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        B3_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (per_sm > B3_BLOCKS_PER_SM) per_sm = B3_BLOCKS_PER_SM;
  const long long grid = items < (long long)per_sm * sms
                             ? items : (long long)per_sm * sms;
  kern<<<(int)grid, B3_THREADS, smem, st>>>(ext, rows, len, lag, span,
                                            floors, n_out, metric, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The window-sum path: the geometries the persistent kernel does not take.
//
// span > W3_DIRECT (OFDM M >= 1,152): the window sums of window_sums.cuh
// (shared with kernel B2), in chunks of W3_CH terms: w3_totals_kernel sums
// each chunk into 16 bytes of scratch, and w3_metric_kernel takes one
// chunk of outputs of one block at a time (a tile), forms its windows
// (w3_window_sums) and writes metric and c, staged in shared memory for
// coalesced stores.  Its grid is persistent: the blocks an SM holds walk
// the tiles, the copies of a block's next tile in flight while it scans
// this one.  c and e1 never go to device memory: the only scratch is one
// float4 per chunk.
//
// span <= W3_DIRECT: w3_direct_kernel stages a tile of W3_CH outputs with
// its span + lag halo and sums each window's few terms in order.
//
// What bounds it on the card: device-memory traffic, 8 B read and 12 B
// written per output.  Each term is formed three times (once for its
// chunk total, once in each of the two tiles whose scans read it), from
// samples that L2 serves after the first read.  Seven terms a thread and
// 128 threads a block measured fastest of the variants tried at M = 1,152
// and 4,096 (scripts/kernel_variants.py --w3, NVIDIA H100 80GB HBM3 at a
// 700.00 W power limit: 16.9 and 18.3 us, against 18.8 and 25.2 us with
// three terms and 256 threads).
#define W3_DIRECT 9                  // spans summed term by term

// A persistent grid: the blocks an SM holds walk the tiles with a grid
// stride, and the copies of a block's next tile are in flight (into the
// second of two staging buffers) while it scans and stores this one.
static __global__ void __launch_bounds__(W3_THREADS)
w3_metric_kernel(const float2* __restrict__ ext, int len, int lag, int span,
                 int nch, int nblk, unsigned tiles,
                 const float* __restrict__ floors, int n_out,
                 const float4* __restrict__ tot, float* __restrict__ metric,
                 float2* __restrict__ c) {
  extern __shared__ __align__(16) float2 w3s[];
  const int tid = threadIdx.x;
  const int nb = w3_buf(lag, nch);
  float* wt = reinterpret_cast<float*>(w3s + 2 * nb);  // [2][4][warps]
  unsigned it = blockIdx.x;  // < tiles: the grid holds at most one a tile
  W3Tile t = w3_tile(it, span, W3_CH, nch, nblk);
  w3_stage_tile(w3s, t, ext, len, lag, span, nch, nblk, tot);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int buf = 0; it < tiles; it += gridDim.x, buf ^= 1) {
    float2* XA = w3s + buf * nb;    // block b:     n0 + [0, nl + lag)
    float2* XB = XA + w3_half(lag);  // block b + 1
    // 1. The next tile's copies into the other buffer (free since the
    //    barrier ending the last iteration), then wait for this tile's.
    const unsigned nxt = it + gridDim.x;
    const W3Tile tn = w3_tile(nxt < tiles ? nxt : it, span, W3_CH, nch,
                                nblk);
    if (nxt < tiles)
      w3_stage_tile(w3s + (buf ^ 1) * nb, tn, ext, len, lag, span, nch, nblk,
                    tot);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (t.n0 >= n_out) {  // past the row's outputs (uniform)
      __syncthreads();
      t = tn;
      continue;
    }
    const int nl = t.nl;

    // 2. The windows and the gated metric of the tile's outputs, staged
    //    over this buffer's samples (every thread is past its reads of
    //    them), then coalesced stores.
    const float floor_v = floors[t.row];
    float2* cst = XA;
    float* mst = reinterpret_cast<float*>(XB);
    w3_window_sums(XA, lag, nch, t.k, nl, wt, [&](int r, const float* w) {
      const int i = tid * W3_R + r;
      cst[i] = make_float2(w[0], w[1]);
      mst[i] = ws_metric(cst[i], w[2], w[3], floor_v);
    });
    __syncthreads();
    const int nv = (int)min((long long)nl, n_out - t.n0);
    float* mrow = metric + t.row * n_out + t.n0;
    float2* crow = c + t.row * n_out + t.n0;
    for (int i = tid; i < nv; i += W3_THREADS) {
      mrow[i] = mst[i];
      crow[i] = cst[i];
    }
    __syncthreads();  // this buffer is staged again two tiles on
    t = tn;
  }
}

// span <= W3_DIRECT: a tile of W3_CH outputs, each window summed term by
// term from the staged samples; a thread's outputs lie W3_THREADS apart,
// so the lanes read neighbouring samples and store coalesced.
static __global__ void __launch_bounds__(W3_THREADS)
w3_direct_kernel(const float2* __restrict__ ext, int len, int lag, int span,
                 int ntile, const float* __restrict__ floors, int n_out,
                 float* __restrict__ metric, float2* __restrict__ c) {
  extern __shared__ __align__(16) float2 w3s[];
  const long long row = blockIdx.x / ntile;
  const long long n0 = (long long)(blockIdx.x % ntile) * W3_CH;
  const float2* rp = ext + row * len;
  w3_stage(w3s, rp, len, n0, W3_CH + span + lag);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float floor_v = floors[row];
#pragma unroll
  for (int r = 0; r < W3_R; ++r) {
    const int i = r * W3_THREADS + threadIdx.x;
    const long long n = n0 + i;
    if (n < n_out) {
      float wv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < span; ++j) {
        float v[4];
        w3_term(w3s[i + j], w3s[i + j + lag], v);
#pragma unroll
        for (int p = 0; p < 4; ++p) wv[p] += v[p];
      }
      const float2 cv = make_float2(wv[0], wv[1]);
      metric[row * n_out + n] = ws_metric(cv, wv[2], wv[3], floor_v);
      c[row * n_out + n] = cv;
    }
  }
}

// Chunks a block, blocks holding outputs.
static void w3_geometry(int n_out, int span, int* nch, int* nblk) {
  *nch = (span + W3_CH - 1) / W3_CH;
  *nblk = (n_out + span - 1) / span;
}

// Bytes of scratch that autocorr_metric_launch needs at this geometry (0
// for the persistent kernel and the direct sums).
extern "C" long long autocorr_metric_scratch(int rows, int n_out, int lag,
                                             int span) {
  if (metric_one_pass(lag, span) || span <= W3_DIRECT) return 0;
  int nch, nblk;
  w3_geometry(n_out, span, &nch, &nblk);
  return (long long)sizeof(float4) * rows * (nblk + 1) * nch;
}

// ext: [rows, len] complex64 on the device; floors: [rows] float.
// Outputs [rows, n_out], n_out = len - span - lag + 1: metric float, c
// complex64 (float2); 16-byte aligned for the persistent kernel.  scratch:
// autocorr_metric_scratch bytes on the device.  Returns the CUDA error code
// of the launches (0 = success; cudaErrorInvalidValue for what it does not
// take).
extern "C" int autocorr_metric_launch(const void* ext, int rows, int len,
                                      int lag, int span, const void* floors,
                                      int n_out, void* metric, void* c,
                                      void* scratch, void* stream) {
  if (rows <= 0 || lag <= 0 || span <= 0 || n_out <= 0 ||
      n_out != len - span - lag + 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (metric_one_pass(lag, span))
    return metric_launch_one_pass((const float2*)ext, rows, len, lag, span,
                                  (const float*)floors, n_out,
                                  (float*)metric, (float2*)c, st);
  cudaError_t err;
  if (span <= W3_DIRECT) {
    const int ntile = (n_out + W3_CH - 1) / W3_CH;
    const long long grid = (long long)rows * ntile;
    const size_t smem = sizeof(float2) * (size_t)(W3_CH + span + lag);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    err = w3_smem_attr((const void*)w3_direct_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    w3_direct_kernel<<<(unsigned)grid, W3_THREADS, smem, st>>>(
        (const float2*)ext, len, lag, span, ntile, (const float*)floors,
        n_out, (float*)metric, (float2*)c);
    return (int)cudaGetLastError();
  }
  int nch, nblk;
  w3_geometry(n_out, span, &nch, &nblk);
  const long long tgrid = (long long)rows * (nblk + 1) * nch;
  const long long tiles = (long long)rows * nblk * nch;
  if (tgrid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float2) * 2 * (size_t)w3_buf(lag, nch) +
                      sizeof(float) * 8 * W3_WARPS;
  long long mgrid = 0;
  err = w3_persistent_grid((const void*)w3_metric_kernel, smem, tiles,
                           &mgrid);
  if (err != cudaSuccess) return (int)err;
  float4* tot = (float4*)scratch;
  w3_totals_kernel<W3_CH><<<(unsigned)tgrid, W3_THREADS, 0, st>>>(
      (const float2*)ext, len, lag, span, W3_CH, nch, nblk + 1, tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  w3_metric_kernel<<<(unsigned)mgrid, W3_THREADS, smem, st>>>(
      (const float2*)ext, len, lag, span, nch, nblk, (unsigned)tiles,
      (const float*)floors, n_out, tot, (float*)metric, (float2*)c);
  return (int)cudaGetLastError();
}
