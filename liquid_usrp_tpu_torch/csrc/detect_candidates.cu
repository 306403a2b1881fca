// Fused S0 candidate detection (kernel B2): Schmidl-Cox metric, centered
// NMS window max, threshold and region mask, and a per-64-sample segment
// reduction, in one pass.
//
// Replaces the TPU kernel liquid_usrp_tpu/ops/pallas_kernels.py ::
// detect_candidates_onepass (body _cand_kernel).  For every offset m:
//
//   c[m]  = sum_{i<span} x[m+i] * conj(x[m+i+lag])
//   e1[m] = sum_{i<span} |x[m+i]|^2,   e2[m] = e1[m+lag]
//   metric[m] = |c|^2 / max(e1*e2, 1e-12), or 0 unless min(e1, e2) > floor
//
// and for every output n (score -1 where a test fails):
//
//   score[n] = metric[n]  if metric[n] >= max(metric[n-win .. n+win])
//                         and metric[n] > thr and win <= n < T + win
//                         and n < n_out
//
// Each 64-sample segment writes its max score, the first offset holding it
// (ties to the lowest offset) and c at that offset.  The top-k over the
// segment maxima runs after the kernel (torch.topk), as the JAX wrapper
// runs lax.top_k after its kernel.  Beyond the row end the stream repeats
// its last sample and before its start it reads zero, as the JAX wrapper
// pads.
//
// What bounds it on the card: device-memory traffic.  Each output reads
// one complex64 sample (8 B); the full-rate metric and correlation never
// leave the chip and only 16 B per 64 outputs are written.  The design
// keeps the on-chip work per output small and constant (about 20
// shared-memory accesses, no loop over the span or the NMS window):
//
// * A block owns CAND_R * CAND_THREADS offsets: a tile of TO outputs (a
//   multiple of 64, 2,112 at M=48) plus its 2*win + 2*lag + span - 1 halo,
//   staged once with 16-byte cp.async copies.
// * Each thread owns one chunk of CAND_R consecutive offsets.  Window sums
//   take the van Herk / Gil-Werman form: a window of span terms is the
//   suffix sum of its first chunk (registers), the totals of the chunks in
//   between and the prefix sum of its last chunk (shared memory).  Every
//   window is a sum of its own terms only, with no subtraction, so a loud
//   burst leaves no residue in the sums of the quiet samples after it (the
//   trouble of a sliding add-and-subtract sum in float32).
// * e2[m] = e1[m + lag] is a read of the e1 plane, not a sum.
// * The 2*win+1 NMS max takes the same form with max: suffix max of the
//   own chunk, chunk maxima in between, prefix max of the last chunk.  Max
//   is exact, so it equals the direct scan bit for bit.
// * CAND_R is odd: lanes that read at a stride of CAND_R words (or float2)
//   hit distinct banks.
// * Each thread keeps its outputs' best score and first offset per
//   segment (its 9 outputs touch at most two); one thread per segment then
//   scans the parts of the at most 8 threads it spans, in order, so ties
//   go to the lowest offset, and writes c there from shared memory.
// * The geometry of M = 48 is a template instance, so its loops unroll
//   with constant bounds and no bounds tests; every other geometry that
//   the kernel takes runs the generic instance.
//
// A block's halo (2*win + 2*lag + span - 1, about 4.25 M samples) must
// leave a tile of at least CAND_SEG of its CAND_SPAN offsets, and span is
// at most 3 * CAND_THREADS + CAND_PAD, so the one-pass kernel takes OFDM M
// up to 475.  Every other geometry, up to any M the JAX package takes, runs
// three passes through device memory whose windows need no halo on chip
// (see the second half of this file and window_sums.cuh); it writes and
// reads back c, e1 and a score per output, about 40 B an output against
// the one-pass kernel's 8.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_sums.cuh"

#define CAND_SEG 64       // outputs per reduced segment
#define CAND_R 9          // offsets per thread chunk (odd)
#define CAND_THREADS 256  // one chunk per thread
#define CAND_SPAN (CAND_R * CAND_THREADS)
#define CAND_PAD 64       // shared floats past the end, for unused reads

// Outputs of one tile: the most whole segments whose lag products (the
// tile, its 2*win NMS margin, lag more for e2 and span - 1 for the last
// window) fit the block's chunks.
__host__ __device__ constexpr int cand_tile(int lag, int span, int win) {
  return (CAND_SPAN - 2 * win - lag - span + 1) / CAND_SEG * CAND_SEG;
}

// Shared-memory floats of one block: the staged samples (later e1 and
// Im c, then the segment parts' offsets), 3 planes of in-chunk prefix sums
// (later the metric, its in-chunk prefix max and Re c), 3 planes of chunk
// totals (later the chunk maxima and the segment parts' scores), and a
// pad.  Every thread computes all CAND_R offsets of its chunk with no
// bounds test: offsets past the tile give values no output reads, and the
// pad (CAND_PAD, or K + 1 floats for the K = (span - 1) / CAND_R chunk
// totals that the last thread's windows read past the third plane, if
// more) keeps those reads inside the block's memory.
__host__ __device__ constexpr int cand_smem_floats(int lag, int span) {
  return 2 * (CAND_SPAN + lag + 2) + 3 * CAND_SPAN + 3 * CAND_THREADS +
         ((span - 1) / CAND_R + 1 > CAND_PAD ? (span - 1) / CAND_R + 1
                                             : CAND_PAD);
}

__device__ inline float2 cand_sample(const float2* __restrict__ row, int len,
                                     int g) {
  if (g < 0) return make_float2(0.f, 0.f);
  return row[g < len ? g : len - 1];
}

// LAG, SPAN, WIN > 0: the detect geometry as compile-time constants (M =
// 48), so every loop unrolls with constant bounds; 0, 0, 0: the same
// kernel for any geometry, from lag_rt, span_rt, win_rt.
template <int LAG, int SPAN, int WIN>
__global__ void __launch_bounds__(CAND_THREADS, 3)
detect_candidates_kernel(const float2* __restrict__ ext, int len, int lag_rt,
                         int span_rt, int win_rt, int T, float thr,
                         const float* __restrict__ floors, int n_out,
                         int n_seg, float* __restrict__ segval,
                         int* __restrict__ segarg,
                         float* __restrict__ segcre,
                         float* __restrict__ segcim) {
  extern __shared__ __align__(16) float sm[];
  const int lag = LAG ? LAG : lag_rt;
  const int span = SPAN ? SPAN : span_rt;
  const int win = WIN ? WIN : win_rt;
  const int TO = cand_tile(lag, span, win);
  const int nt = CAND_THREADS;
  const int cap = CAND_SPAN;
  const int nx = cap + lag;                    // staged samples
  float2* xs = reinterpret_cast<float2*>(sm);  // nx + 2 samples
  float* pre = sm + 2 * (nx + 2);              // 3 planes of cap
  float* csum = pre + 3 * cap;                 // 3 planes of nt
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * TO;
  const int m0 = n0 - win;  // stream offset of tile offset 0
  const float2* rp = ext + (long long)row * len;
  const bool vec = ((uintptr_t)ext & 15) == 0;

  // 1. Stage samples [m0, m0 + nx) as 16-byte pairs aligned in the whole
  //    tensor; X[i] is sample m0 + i.
  const int s = (int)(((long long)row * len + m0) & 1);
  const float2* X = xs + s;
  const int npair = (nx + s + 1) >> 1;
  for (int p = tid; p < npair; p += nt) {
    const int gi = m0 - s + 2 * p;
    if (vec && gi >= 0 && gi + 1 < len) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(xs + 2 * p);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(rp + gi)
                   : "memory");
    } else {
      xs[2 * p] = cand_sample(rp, len, gi);
      xs[2 * p + 1] = cand_sample(rp, len, gi + 1);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. Lag products of the own chunk: in-chunk prefix sums to shared
  //    memory, chunk totals, in-chunk suffix sums kept in registers.
  const int q0 = tid * CAND_R;
  float sr[CAND_R], si[CAND_R], sp[CAND_R];
  {
    float ar = 0.f, ai = 0.f, ap = 0.f;
#pragma unroll
    for (int r = 0; r < CAND_R; ++r) {
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
    for (int r = CAND_R - 2; r >= 0; --r) {
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
  //    goes to shared memory for e2.
  float* e1s = sm;
  float cr[CAND_R], ci[CAND_R], e1[CAND_R];
  {
    const int K = (span - 1) / CAND_R;
    const int rs = CAND_R * (K + 1) - span + 1;
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
    for (int r = 0; r < CAND_R; ++r) {
      const int e = q0 + r + span - 1;
      cr[r] = (sr[r] + (r < rs ? mr : mr1)) + pre[e];
      ci[r] = (si[r] + (r < rs ? mi : mi1)) + pre[cap + e];
      e1[r] = (sp[r] + (r < rs ? mp : mp1)) + pre[2 * cap + e];
      e1s[q0 + r] = e1[r];
    }
  }
  __syncthreads();

  // 4. The floor-gated metric of the own offsets, its in-chunk prefix max
  //    (shared), chunk max, and in-chunk suffix max (registers); c to
  //    shared memory, for the segment picks.
  float* met = pre;
  float* pmax = pre + cap;
  float* cmax = csum;
  float* cre = pre + 2 * cap;  // the e1 prefix plane, read in 3
  float* cim = sm + cap + lag; // past e1
  const float floor_v = floors[row];
  float mt[CAND_R];
  {
    float run = -INFINITY;
#pragma unroll
    for (int r = 0; r < CAND_R; ++r) {
      const float e2 = e1s[q0 + r + lag];
      const float c2 = cr[r] * cr[r] + ci[r] * ci[r];
      const float m = (fminf(e1[r], e2) > floor_v)
                          ? __fdividef(c2, fmaxf(e1[r] * e2, 1e-12f))
                          : 0.f;
      met[q0 + r] = m;
      run = fmaxf(run, m);
      pmax[q0 + r] = run;
      mt[r] = m;
      cre[q0 + r] = cr[r];
      cim[q0 + r] = ci[r];
    }
    cmax[tid] = run;
#pragma unroll
    for (int r = CAND_R - 2; r >= 0; --r) mt[r] = fmaxf(mt[r], mt[r + 1]);
  }
  __syncthreads();

  // 5. NMS and the tests for the own outputs j = q0 + r (metric offsets
  //    [j, j + 2 win], split as in 3); the own outputs' best score and its
  //    first offset in each of the (at most two) segments they touch.
  float* part_v = csum + nt;             // [nt][2], chunk planes 1-2
  int* part_j = reinterpret_cast<int*>(sm);  // [nt][2], past use of e1
  {
    const int K = 2 * win / CAND_R;
    const int rs = CAND_R * (K + 1) - 2 * win;
    float mm = -INFINITY;
#pragma unroll
    for (int k = 1; k < K; ++k) mm = fmaxf(mm, cmax[tid + k]);
    const float mm1 = fmaxf(mm, cmax[tid + K]);
    const int seg0 = q0 / CAND_SEG;  // own outputs: segments seg0, seg0 + 1
    float bv0 = -2.f, bv1 = -2.f;
    int bj0 = 0, bj1 = 0;
#pragma unroll
    for (int r = 0; r < CAND_R; ++r) {
      const int j = q0 + r;
      const float lmax =
          fmaxf(fmaxf(mt[r], r < rs ? mm : mm1), pmax[j + 2 * win]);
      const float mv = met[j + win];
      const int n = n0 + j;
      const bool ok = (mv >= lmax) && (mv > thr) && (n >= win) &&
                      (n < T + win) && (n < n_out);
      const float sc = ok ? mv : -1.f;
      const bool hi = j / CAND_SEG != seg0;  // CAND_R < CAND_SEG
      if (!hi && sc > bv0) {                 // ties keep the lower offset
        bv0 = sc;
        bj0 = j;
      }
      if (hi && sc > bv1) {
        bv1 = sc;
        bj1 = j;
      }
    }
    part_v[2 * tid] = bv0;
    part_v[2 * tid + 1] = bv1;
    part_j[2 * tid] = bj0;
    part_j[2 * tid + 1] = bj1;
  }
  __syncthreads();

  // 6. Each segment's max score at its first offset, from the parts of the
  //    threads whose outputs it holds (in order, so ties keep the lowest
  //    offset), and c there.
  if (tid < TO / CAND_SEG && n0 / CAND_SEG + tid < n_seg) {
    const int g = tid;
    float best_v = -2.f;
    int best_j = 0;
    for (int t = g * CAND_SEG / CAND_R;
         t <= (g * CAND_SEG + CAND_SEG - 1) / CAND_R; ++t) {
      const int h = t * CAND_R / CAND_SEG == g ? 0 : 1;
      if (part_v[2 * t + h] > best_v) {
        best_v = part_v[2 * t + h];
        best_j = part_j[2 * t + h];
      }
    }
    const long long o = (long long)row * n_seg + n0 / CAND_SEG + g;
    segval[o] = best_v;
    segarg[o] = n0 + best_j;
    segcre[o] = cre[best_j + win];
    segcim[o] = cim[best_j + win];
  }
}

typedef void (*CandKernel)(const float2*, int, int, int, int, int, float,
                           const float*, int, int, float*, int*, float*,
                           float*);

// Whether the one-pass kernel above takes the geometry: CAND_R < span,
// CAND_R <= 2 win, a tile of at least one segment and the span's staged
// samples within the block's threads.
static bool cand_one_pass(int lag, int span, int win) {
  return span > CAND_R && 2 * win >= CAND_R &&
         cand_tile(lag, span, win) >= CAND_SEG &&
         span <= 3 * CAND_THREADS + CAND_PAD;
}

// The instantiation for a geometry: M = 48, the one the paths run, else
// the generic one.
static CandKernel cand_kernel(int lag, int span, int win) {
  if (lag == 12 && span == 84 && win == 48)
    return detect_candidates_kernel<12, 84, 48>;
  return detect_candidates_kernel<0, 0, 0>;
}

static int cand_launch_one_pass(const float2* ext, int rows, int len,
                                int lag, int span, int win, int T, float thr,
                                const float* floors, int n_out, int n_seg,
                                float* segval, int* segarg, float* segcre,
                                float* segcim, cudaStream_t st) {
  const int TO = cand_tile(lag, span, win);
  const size_t smem = sizeof(float) * (size_t)cand_smem_floats(lag, span);
  // all of the SM's shared memory for blocks: three blocks share an SM
  const CandKernel kern = cand_kernel(lag, span, win);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  // rows in runs of the grid's y limit
  for (int r0 = 0; err == cudaSuccess && r0 < rows; r0 += 65535) {
    const int nr = rows - r0 < 65535 ? rows - r0 : 65535;
    const long long o = (long long)r0 * n_seg;
    dim3 grid((n_seg * CAND_SEG + TO - 1) / TO, nr);
    kern<<<grid, CAND_THREADS, smem, st>>>(
        ext + (long long)r0 * len, len, lag, span, win, T, thr, floors + r0,
        n_out, n_seg, segval + o, segarg + o, segcre + o, segcim + o);
    err = cudaGetLastError();
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// Every other geometry: three passes through device memory, with windows of
// any length in the split form of window_sums.cuh (each window a sum or max
// of its own terms only, as above):
// 1. ws_lag_sums_kernel: c [n_out] and e1 [n_out + lag] of each row;
// 2. cand_nms_kernel: the 2 win + 1 NMS max over the metric (made from c
//    and e1; -inf outside [0, n_out), as the plain version pads) and the
//    score of every output n < n_seg * 64;
// 3. cand_seg_kernel: each segment's max score, its first offset and c
//    there.
// c, e1 and the scores live in the caller's scratch (its bytes from
// detect_candidates_scratch).
// ---------------------------------------------------------------------------

struct CandNms {
  const float2* c;  // this row's [n_out]
  const float* e1;  // this row's [n_out + lag]
  long long n_out;
  int lag, win, T;
  float thr, floor_v;
  float* score;     // this row's [n_seg * CAND_SEG]
  __device__ float metric(long long v) const {
    if (v < 0 || v >= n_out) return -INFINITY;
    return ws_metric(c[v], e1[v], e1[v + lag], floor_v);
  }
  // term t of output n's window [n - win, n + win] is metric[t - win]
  __device__ WsVec<1> term(long long t) const {
    WsVec<1> r;
    r.v[0] = metric(t - win);
    return r;
  }
  __device__ void put(long long n, const WsVec<1>& v) { score[n] = v.v[0]; }
  __device__ WsVec<1> get(long long n) const {
    WsVec<1> r;
    r.v[0] = score[n];
    return r;
  }
  __device__ void done(long long n, const WsVec<1>& lmax) {
    const float mv = metric(n);
    const bool ok = (mv >= lmax.v[0]) && (mv > thr) && (n >= win) &&
                    (n < (long long)T + win) && (n < n_out);
    score[n] = ok ? mv : -1.f;
  }
};

static __global__ void __launch_bounds__(WS_THREADS)
cand_nms_kernel(const float2* __restrict__ c, const float* __restrict__ e1,
                long long rows, long long n_out, int lag, int win, int T,
                float thr, const float* __restrict__ floors, long long n_u,
                long long nblk, float* __restrict__ score) {
  long long row, b;
  if (!ws_warp(rows, nblk, &row, &b)) return;
  CandNms acc{c + row * n_out, e1 + row * (n_out + lag), n_out, lag, win, T,
              thr, floors[row], score + row * n_u};
  ws_block<1, true>(acc, b, 2 * win + 1, n_u, threadIdx.x & 31);
}

// One thread a (row, segment): the first offset of the segment's max
// score (ties keep the lowest) and c there.
static __global__ void __launch_bounds__(CAND_THREADS)
cand_seg_kernel(const float* __restrict__ score, const float2* __restrict__ c,
                long long rows, long long n_out, int n_seg,
                float* __restrict__ segval, int* __restrict__ segarg,
                float* __restrict__ segcre, float* __restrict__ segcim) {
  const long long i = (long long)blockIdx.x * CAND_THREADS + threadIdx.x;
  if (i >= rows * n_seg) return;
  const long long row = i / n_seg;
  const float* s = score + i * CAND_SEG;
  float best_v = -2.f;
  int best_j = 0;
  for (int j = 0; j < CAND_SEG; ++j) {
    const float v = s[j];
    if (v > best_v) {
      best_v = v;
      best_j = j;
    }
  }
  const long long n = (i - row * n_seg) * CAND_SEG + best_j;
  const float2 cv = c[row * n_out + (n < n_out ? n : n_out - 1)];
  segval[i] = best_v;
  segarg[i] = (int)n;
  segcre[i] = cv.x;
  segcim[i] = cv.y;
}

static size_t cand_align(long long bytes) {
  return (size_t)((bytes + 255) & ~255LL);
}

// Bytes of scratch that detect_candidates_launch needs at this geometry
// (0 for the one-pass kernel).
extern "C" long long detect_candidates_scratch(int rows, int n_out, int lag,
                                               int span, int win,
                                               int n_seg) {
  if (cand_one_pass(lag, span, win)) return 0;
  return (long long)(cand_align(8LL * rows * n_out) +
                     cand_align(4LL * rows * ((long long)n_out + lag)) +
                     cand_align(4LL * rows * n_seg * CAND_SEG));
}

// ext: [rows, len] complex64 on the device; floors: [rows] float; n_out =
// len - span - lag + 1.  Outputs [rows, n_seg]: segval float, segarg
// int32, segcre/segcim float.  scratch: detect_candidates_scratch bytes on
// the device.  Returns the CUDA error code of the launches (0 = success).
extern "C" int detect_candidates_launch(const void* ext, int rows, int len,
                                        int lag, int span, int win, int T,
                                        float thr, const void* floors,
                                        int n_out, int n_seg, void* segval,
                                        void* segarg, void* segcre,
                                        void* segcim, void* scratch,
                                        void* stream) {
  if (rows <= 0 || len <= 0 || lag <= 0 || span <= 0 || win < 0 ||
      n_out <= 0 || n_out != len - span - lag + 1 || n_seg <= 0 ||
      (long long)n_seg * CAND_SEG < n_out)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cand_one_pass(lag, span, win))
    return cand_launch_one_pass(
        (const float2*)ext, rows, len, lag, span, win, T, thr,
        (const float*)floors, n_out, n_seg, (float*)segval, (int*)segarg,
        (float*)segcre, (float*)segcim, st);
  char* sp = (char*)scratch;
  float2* c = (float2*)sp;
  float* e1 = (float*)(sp + cand_align(8LL * rows * n_out));
  float* score = (float*)((char*)e1 +
                          cand_align(4LL * rows * ((long long)n_out + lag)));
  cudaError_t err = ws_lag_sums((const float2*)ext, rows, len, lag, span,
                                n_out, c, e1, st);
  if (err != cudaSuccess) return (int)err;
  const long long n_u = (long long)n_seg * CAND_SEG;
  const long long nblk = (n_u + 2 * win) / (2 * win + 1);
  const long long grid = ws_grid(rows, nblk);
  const long long sgrid =
      ((long long)rows * n_seg + CAND_THREADS - 1) / CAND_THREADS;
  if (grid > 0x7fffffff || sgrid > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  cand_nms_kernel<<<(unsigned)grid, WS_THREADS, 0, st>>>(
      c, e1, rows, n_out, lag, win, T, thr, (const float*)floors, n_u, nblk,
      score);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cand_seg_kernel<<<(unsigned)sgrid, CAND_THREADS, 0, st>>>(
      score, c, rows, n_out, n_seg, (float*)segval, (int*)segarg,
      (float*)segcre, (float*)segcim);
  return (int)cudaGetLastError();
}
