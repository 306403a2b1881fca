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
// the window-sum path of the second half of this file, whose windows need
// no halo on chip (window_sums.cuh, shared with kernel B3).
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
// Every other geometry (OFDM M >= 476, and any lag, span or win that the
// one-pass kernel refuses): the window-sum path, three kernels with
// nothing full-rate in device memory but one float32 metric plane:
//
// 1. w3_totals_kernel (window_sums.cuh, shared with kernel B3): the chunk
//    totals of the span-window sums, 16 B a chunk.  A block of span terms
//    is cut into nch balanced chunks (ch = ceil(span / nch) <= W3_CH
//    terms); a block of one chunk (span <= W3_CH, OFDM M <= 512) needs no
//    totals and the kernel does not run.
// 2. cand_sums_kernel: a tile is one chunk of outputs of one block; it
//    forms its windows on chip (w3_window_sums: c, e1 and e2 never leave
//    the chip), its metric, and stores the metric (the plane) and, for
//    each part of a 64-output segment that it holds, a record: the
//    metric's max over the part, the first offset of the part's best
//    pre-score (the metric where n is in the region and the metric over
//    the threshold, else -1), whether a later offset of the part ties it,
//    c there and, in the segment's first part, c at its first offset.
//    Each thread sums up its W3_R outputs in the (at most two) segments
//    they meet in registers; one thread a part then combines the threads'
//    summaries in order from shared memory, so ties keep the lower
//    offset.  A segment meets at most P tiles (its parts): 2 wherever a
//    tile holds at least 63 outputs, as at every OFDM M >= 476, up to 64
//    for a span of 1.  The grid is persistent, with the next tile's
//    copies in flight, as B3's.
// 3. cand_pick_kernel: the segment's best pre-score v at its first
//    offset m, from its parts in order (so ties keep the lower offset).
//    v = -1 (one thread a segment reads it): the segment scores -1 at its
//    first offset.  Otherwise the segment goes on its block's list, and a
//    warp takes it.  win >= 64: the NMS test runs at m alone, since an
//    offset that passes the test has the metric's max over its window,
//    which holds the whole segment; every offset of the segment that
//    scores holds the segment's max metric, and the first of them is m or
//    a later tie of m.  The window max [m - win, m + win] (clamped to
//    [0, n_out), as the plain version pads with -inf) is the metric of
//    its two partial end segments (the plane) and the part maxima of the
//    segments between, exact with no O(win) work an output.  m passes:
//    score v at m, c from its record.  m fails and no later offset ties
//    it: -1 at the segment's first offset, c from its record.  A later
//    tie (an exact plateau whose first offset sees a larger value at its
//    window's edge): the warp tests the later offsets in order, and sums
//    c at the first that passes term by term.  win < 64: the window need
//    not hold the segment, so the warp tests, in order, every offset
//    whose pre-score beats the best score found so far, and sums c term
//    by term at a pick other than m.
//
// What bounds it on the card: device-memory traffic, 8 B read per output;
// the plane adds 4 B written, the records about 48 B a segment, and the
// picks read a few values an interesting segment (L2 holds them: the plane
// is 3.2 MB at M = 512 on 8 x 101,760 windows).  The sums kernel keeps
// c, e1 and e2 on chip, as B3's window sums do; it is bound by its scans
// at five blocks an SM (B2_MINB: 95 registers, faster than 4 or 6 blocks
// an SM or no cap).  The pick kernel's blocks of 1,024 threads spread a
// frame's cluster of segments that may score over 32 warps.  The plane
// stays because a build with no plane, whose pick kernel recomputed each
// metric value it read term by term, measured far slower: on the
// single-channel path's first-dispatch windows with the S0 template in
// every row, B2 took 15.86-15.90 us with the plane and 449.9-450.0 us
// without it at M = 512, 28.08-28.16 and 3,988.7-3,988.8 us at M = 4,096
// (scripts/kernel_variants.py, in turns, NVIDIA H100 80GB HBM3 at a
// 700.00 W power limit).
#define B2_MINB 5   // blocks an SM must hold (caps the registers)
#define CAND_PICK_THREADS 1024

// Views of the scratch: [rows][n_seg][P] for the parts.
struct CandScratch {
  float4* tot;     // [rows][nblk + 1][nch] chunk totals (nch > 1)
  float* plane;    // [rows][n_out] the metric
  float* pmax;     // the metric's max over the part (-inf if empty)
  float* pval;     // the part's best pre-score (-2 if empty)
  unsigned* parg;  // its first offset, a later tie in bit 31
  float2* pc;      // c there
  float2* cf;      // [rows][n_seg] c at the segment's first offset
  int P;           // parts a segment
};

// The window-sum path's chunks and parts: a block of span terms in nch
// balanced chunks of ch terms (the last one, the shortest tile, lmin), so
// that a segment's 64 outputs meet at most P = 62 / lmin + 2 tiles.  It
// takes every geometry whose offsets fit 31 bits (bit 31 of a record is
// its tie flag) and whose chunks are all nonempty (spans up to about
// 800,000).
struct CandGeometry {
  int ch, nch, P;
  long long nblk;
};

static bool cand_geometry(int span, int n_seg, CandGeometry* g) {
  g->nch = (span + W3_CH - 1) / W3_CH;
  g->ch = (span + g->nch - 1) / g->nch;
  g->nblk = ((long long)n_seg * CAND_SEG + span - 1) / span;
  const int lmin = span - (g->nch - 1) * g->ch;
  g->P = lmin > 0 ? (CAND_SEG - 2) / lmin + 2 : 2;
  return lmin > 0 && (long long)n_seg * CAND_SEG <= 0x80000000LL;
}

static size_t cand_align(long long bytes) {
  return (size_t)((bytes + 255) & ~255LL);
}

// The scratch's views from ``base`` (null: sizes only); returns its bytes.
static long long cand_layout(int rows, int n_out, int n_seg,
                             const CandGeometry& g, char* base,
                             CandScratch* sc) {
  const long long np = (long long)g.P * rows * n_seg;
  const long long sizes[7] = {
      g.nch > 1 ? 16LL * rows * (g.nblk + 1) * g.nch : 0,
      4LL * rows * n_out, 4 * np, 4 * np, 4 * np, 8 * np,
      8LL * rows * n_seg};
  char* at[7];
  long long off = 0;
  for (int q = 0; q < 7; ++q) {
    at[q] = base ? base + off : nullptr;
    off += (long long)cand_align(sizes[q]);
  }
  if (sc)
    *sc = CandScratch{(float4*)at[0], (float*)at[1], (float*)at[2],
                      (float*)at[3], (unsigned*)at[4], (float2*)at[5],
                      (float2*)at[6], g.P};
  return off;
}

// The tile of a row that holds output n < 2^31: chunk (n mod span) / ch
// of block n / span.
__device__ inline unsigned cand_tile_of(unsigned n, int span, int ch,
                                        int nch) {
  const unsigned b = n / (unsigned)span;
  return b * (unsigned)nch + (n - b * (unsigned)span) / (unsigned)ch;
}

// A thread's summary of its outputs in one segment (its W3_R outputs meet
// at most two): the metric's max, the best pre-score, its first output
// (tile index) and how many of its outputs hold that score.
struct CandSum {
  float vmax, v;
  int m, ties;
  __device__ void add(float mv, float ps, int i) {
    vmax = fmaxf(vmax, mv);
    if (ps > v) {  // the outputs come in order: ties keep the first
      v = ps;
      m = i;
      ties = 1;
    } else if (ps == v) {
      ++ties;
    }
  }
};

// Shared floats of the thread summaries: 2 per thread of vmax, v, m, ties.
#define CAND_SUMS_SMEM (8 * W3_THREADS)

// The records of the segment parts in outputs [0, ne) (ne <= nl, the
// outputs below n_u) of the row's tile ``tile``, first output n0, from the
// thread summaries ``sm`` (slot 2 t + h: thread t's outputs in its first
// segment, h = 0, or the next one): one thread a part combines the
// summaries of the threads it meets, in order.  A segment's part is the
// count of its tiles before this one; its first part also writes c at its
// first offset and empties the parts past its last tile (with P = 2: the
// second part of a segment inside this tile of nl outputs).
__device__ inline void cand_records(const CandScratch& sc, long long row,
                                    unsigned tile, long long n0, int nl,
                                    int ne, int n_seg, int span, int ch,
                                    int nch, const float* sm,
                                    const float2* cst) {
  const int* smi = reinterpret_cast<const int*>(sm);
  const long long s = n0 / CAND_SEG + threadIdx.x;
  if (s > (n0 + ne - 1) / CAND_SEG) return;
  const long long s0 = s * CAND_SEG;
  const int a = (int)((s0 > n0 ? s0 : n0) - n0);
  const int b = (int)min(s0 + CAND_SEG - n0, (long long)ne);
  CandSum c{-INFINITY, -2.f, a, 0};
  for (int t = a / W3_R; t <= (b - 1) / W3_R; ++t) {
    const int q = 2 * t + ((n0 + t * W3_R) / CAND_SEG != s);
    const float v = sm[2 * W3_THREADS + q];
    c.vmax = fmaxf(c.vmax, sm[q]);
    if (v > c.v) {  // threads in order: ties keep the lower offset
      c.v = v;
      c.m = smi[4 * W3_THREADS + q];
      c.ties = smi[6 * W3_THREADS + q];
    } else if (v == c.v) {
      c.ties += smi[6 * W3_THREADS + q];
    }
  }
  const int part =
      s0 >= n0 ? 0
               : sc.P == 2 ? 1
                           : (int)(tile - cand_tile_of((unsigned)s0, span,
                                                       ch, nch));
  const long long o = (row * n_seg + s) * sc.P;
  sc.pmax[o + part] = c.vmax;
  sc.pval[o + part] = c.v;
  sc.parg[o + part] = (unsigned)(n0 + c.m) |
                      (c.v > -1.f && c.ties > 1 ? 0x80000000u : 0u);
  sc.pc[o + part] = cst[c.m];
  if (part == 0) {
    sc.cf[row * n_seg + s] = cst[a];
    const int q0 =
        sc.P == 2 ? (s0 + CAND_SEG <= n0 + nl ? 1 : 2)
                  : (int)(cand_tile_of((unsigned)(s0 + CAND_SEG - 1), span,
                                       ch, nch) - tile) + 1;
    for (int q = q0; q < sc.P; ++q) {
      sc.pmax[o + q] = -INFINITY;
      sc.pval[o + q] = -2.f;
      sc.parg[o + q] = 0u;
    }
  }
}

static __global__ void __launch_bounds__(W3_THREADS, B2_MINB)
cand_sums_kernel(const float2* __restrict__ ext, int len, int lag, int span,
                 int ch, int nch, int nblk, unsigned tiles,
                 const float* __restrict__ floors, int n_out, int n_seg,
                 int win, int T, float thr, CandScratch sc) {
  extern __shared__ __align__(16) float2 w3s[];
  const int tid = threadIdx.x;
  const long long n_u = (long long)n_seg * CAND_SEG;
  const int nb = w3_buf(lag, nch);
  float* wt = reinterpret_cast<float*>(w3s + 2 * nb);  // [2][4][warps]
  unsigned it = blockIdx.x;  // < tiles: the grid holds at most one a tile
  W3Tile t = w3_tile(it, span, ch, nch, nblk);
  w3_stage_tile(w3s, t, ext, len, lag, span, nch, nblk, sc.tot);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int buf = 0; it < tiles; it += gridDim.x, buf ^= 1) {
    float2* XA = w3s + buf * nb;
    // 1. The next tile's copies into the other buffer (free since the
    //    barrier ending the last iteration), then wait for this tile's.
    const unsigned nxt = it + gridDim.x;
    const W3Tile tn = w3_tile(nxt < tiles ? nxt : it, span, ch, nch, nblk);
    if (nxt < tiles)
      w3_stage_tile(w3s + (buf ^ 1) * nb, tn, ext, len, lag, span, nch, nblk,
                    sc.tot);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (t.n0 >= n_u) {  // past the row's segments (uniform)
      __syncthreads();
      t = tn;
      continue;
    }
    const int nl = t.nl;

    // 2. The windows and the gated metric of the tile's outputs, staged
    //    over this buffer's samples (every thread is past its reads), and
    //    the thread's summaries of the (at most two) segments its outputs
    //    meet.
    const float floor_v = floors[t.row];
    float2* cst = XA;
    float* mst = reinterpret_cast<float*>(XA + w3_half(lag));
    const int ne = (int)min((long long)nl, n_u - t.n0);
    const long long s_t = (t.n0 + tid * W3_R) / CAND_SEG;
    CandSum h0{-INFINITY, -2.f, 0, 0}, h1{-INFINITY, -2.f, 0, 0};
    w3_window_sums(XA, lag, nch, t.k, nl, wt, [&](int r, const float* w) {
      const int i = tid * W3_R + r;
      const long long n = t.n0 + i;
      cst[i] = make_float2(w[0], w[1]);
      const float mv = ws_metric(cst[i], w[2], w[3], floor_v);
      mst[i] = mv;
      if (i < ne) {
        const bool ok = n < n_out && n >= win && n < (long long)T + win &&
                        mv > thr;
        const float mx = n < n_out ? mv : -INFINITY;
        if (n / CAND_SEG == s_t)
          h0.add(mx, ok ? mv : -1.f, i);
        else
          h1.add(mx, ok ? mv : -1.f, i);
      }
    });
    float* sm = wt + 8 * W3_WARPS;
    int* smi = reinterpret_cast<int*>(sm);
    sm[2 * tid] = h0.vmax;
    sm[2 * tid + 1] = h1.vmax;
    sm[2 * W3_THREADS + 2 * tid] = h0.v;
    sm[2 * W3_THREADS + 2 * tid + 1] = h1.v;
    smi[4 * W3_THREADS + 2 * tid] = h0.m;
    smi[4 * W3_THREADS + 2 * tid + 1] = h1.m;
    smi[6 * W3_THREADS + 2 * tid] = h0.ties;
    smi[6 * W3_THREADS + 2 * tid + 1] = h1.ties;
    __syncthreads();

    // 3. The metric plane (coalesced), and the records of the segment
    //    parts the tile holds.
    const int nv = (int)min((long long)nl, n_out - t.n0);
    float* mrow = sc.plane + t.row * n_out + t.n0;
    for (int i = tid; i < nv; i += W3_THREADS) mrow[i] = mst[i];
    cand_records(sc, t.row, (unsigned)t.b * nch + t.k, t.n0, nl, ne, n_seg,
                 span, ch, nch, sm, cst);
    __syncthreads();  // this buffer is staged again two tiles on
    t = tn;
  }
}

// The picks' view of one row.
struct CandRow {
  const float2* rp;    // the samples
  const float* prow;   // the metric plane's row
  const float* pmax;   // the row's part maxima
  int len, lag, span, win, n_out, P;
  float thr;
};

// Terms lane, lane + 32, ... of the four window sums at offset v, summed
// over the warp.
__device__ inline void cand_direct(const CandRow& r, long long v, int lane,
                                   float* w) {
  w[0] = w[1] = w[2] = w[3] = 0.f;
  for (int i = lane; i < r.span; i += 32) {
    float t[4];
    w3_term(w3_x(r.rp, r.len, v + i), w3_x(r.rp, r.len, v + i + r.lag), t);
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p] += t[p];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p] += __shfl_xor_sync(0xffffffffu, w[p], d);
}

// max(metric[n - win .. n + win]) within [0, n_out), by the whole warp:
// the metric of the partial segments at the ends (at most 128 offsets
// when the window meets at most two segments, else 64 at each end), the
// part maxima of the segments between; every lane's loads are issued
// before their max is taken.
__device__ inline float cand_window_max(const CandRow& r, long long n,
                                        int lane) {
  const long long lo = n - r.win > 0 ? n - r.win : 0;
  const long long hi = n + r.win < r.n_out ? n + r.win : r.n_out - 1;
  const long long sl = lo / CAND_SEG, sr = hi / CAND_SEG;
  long long a = hi + 1, b = hi + 1;  // metric read over [lo, a), [b, hi]
  long long np = 0;                  // part maxima between
  if (sr - sl > 1) {
    a = (sl + 1) * CAND_SEG;
    b = sr * CAND_SEG;
    np = r.P * (sr - sl - 1);
  }
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long j = lo + lane + 32 * q;
    if (j < a) mx = fmaxf(mx, r.prow[j]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long j = b + lane + 32 * q;
    if (j <= hi) mx = fmaxf(mx, r.prow[j]);
  }
  const float* pm = r.pmax + (sl + 1) * r.P;
#pragma unroll 4
  for (long long q = lane; q < np; q += 32) mx = fmaxf(mx, pm[q]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  return mx;
}

// A segment that may score: its best pre-score v at its first offset m,
// whether a later offset ties it, c there and at the segment's first
// offset.
struct CandBest {
  float v;
  int m, tie;
  float2 cm, cf;
};

// The pick of segment i (row ``row``, first offset s0) from its best
// pre-score (every lane gets it; the whole warp calls it): (value,
// offset, c).
struct CandPick {
  float v;
  long long n;
  float2 c;
};

__device__ inline CandPick cand_pick(const CandRow& r, const CandBest& e,
                                     long long s0, int T, int lane) {
  const CandPick none{-1.f, s0, e.cf};
  const long long end = s0 + CAND_SEG < r.n_out ? s0 + CAND_SEG : r.n_out;
  long long n = -1;  // a pick whose c no record holds
  if (r.win < CAND_SEG) {  // the best score of the segment, in order
    CandPick best = none;
    for (long long j = s0; j < end; ++j) {
      const float mv = r.prow[j];
      if (mv > best.v && mv > r.thr && j >= r.win &&
          j < (long long)T + r.win && cand_window_max(r, j, lane) <= mv) {
        best.v = mv;
        best.n = j;
      }
    }
    if (best.v == -1.f) return none;
    if (best.n == e.m) return CandPick{e.v, e.m, e.cm};
    n = best.n;
  } else {
    if (cand_window_max(r, e.m, lane) <= e.v)
      return CandPick{e.v, e.m, e.cm};
    if (!e.tie) return none;
    for (long long j = e.m + 1; j < end && n < 0; ++j)  // the first later
      if (r.prow[j] == e.v && j >= r.win &&             // tie passing
          j < (long long)T + r.win && cand_window_max(r, j, lane) <= e.v)
        n = j;
    if (n < 0) return none;
  }
  float w[4];  // c there, term by term
  cand_direct(r, n, lane, w);
  return CandPick{r.prow[n], n, make_float2(w[0], w[1])};
}

// One thread a (row, segment) reads its records: a segment that cannot
// score writes -1 at its first offset; one that may (a few a block,
// clustered around a frame) goes on the block's list, and the block's
// warps take the listed segments one each.
static __global__ void __launch_bounds__(CAND_PICK_THREADS)
cand_pick_kernel(const float2* __restrict__ ext, int len, int lag, int span,
                 int win, int T, float thr, int n_out, int n_seg,
                 long long total, CandScratch sc,
                 float* __restrict__ segval, int* __restrict__ segarg,
                 float* __restrict__ segcre, float* __restrict__ segcim) {
  __shared__ CandBest list[CAND_PICK_THREADS];
  __shared__ int at[CAND_PICK_THREADS], listed;
  const long long base = (long long)blockIdx.x * CAND_PICK_THREADS;
  const long long i = base + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  if (i < total) {  // the parts' records in order (the first keeps ties)
    const long long o = i * sc.P;
    float v;
    unsigned a;
    float2 cm;
    bool tie;
    if (sc.P == 2) {  // every OFDM geometry: all loads in flight at once
      const float2 vv = reinterpret_cast<const float2*>(sc.pval)[i];
      const uint2 aa = reinterpret_cast<const uint2*>(sc.parg)[i];
      const float4 cc = reinterpret_cast<const float4*>(sc.pc)[i];
      const bool lo = vv.x >= vv.y;
      v = lo ? vv.x : vv.y;
      a = lo ? aa.x : aa.y;
      cm = lo ? make_float2(cc.x, cc.y) : make_float2(cc.z, cc.w);
      tie = (a >> 31) != 0 || vv.y == vv.x;
    } else {
      v = sc.pval[o];
      a = sc.parg[o];
      cm = sc.pc[o];
      tie = (a >> 31) != 0;
    }
    for (int q = sc.P == 2 ? 2 : 1; q < sc.P; ++q) {
      const float vq = sc.pval[o + q];
      const unsigned aq = sc.parg[o + q];
      const float2 cq = sc.pc[o + q];
      if (vq > v) {
        v = vq;
        a = aq;
        cm = cq;
        tie = (aq >> 31) != 0;
      } else if (vq == v) {
        tie = true;
      }
    }
    const float2 cf = sc.cf[i];
    if (v > -1.f) {
      const int k = atomicAdd(&listed, 1);
      list[k] = CandBest{v, (int)(a & 0x7fffffffu), tie, cm, cf};
      at[k] = threadIdx.x;
    } else {
      segval[i] = -1.f;
      segarg[i] = (int)((i % n_seg) * CAND_SEG);
      segcre[i] = cf.x;
      segcim[i] = cf.y;
    }
  }
  __syncthreads();
  for (int k = warp; k < listed; k += CAND_PICK_THREADS / 32) {
    const long long j = base + at[k];
    const long long row = j / n_seg;
    const CandRow r{ext + row * len, sc.plane + row * n_out,
                    sc.pmax + row * n_seg * sc.P, len, lag, span, win,
                    n_out, sc.P, thr};
    const CandPick p = cand_pick(r, list[k], (j - row * n_seg) * CAND_SEG, T,
                                 lane);
    if (lane == 0) {
      segval[j] = p.v;
      segarg[j] = (int)p.n;
      segcre[j] = p.c.x;
      segcim[j] = p.c.y;
    }
  }
}

// The kernels detect_candidates_launch runs at a geometry (whatever the
// row count and length, which only bound what it takes): 0 the one-pass
// kernel's M = 48 instance, 1 its generic instance, 2 the window-sum
// path's sums and picks, 3 those after its chunk totals.
extern "C" int detect_candidates_path(int lag, int span, int win) {
  if (cand_one_pass(lag, span, win))
    return cand_kernel(lag, span, win) == detect_candidates_kernel<12, 84, 48>
               ? 0 : 1;
  CandGeometry g;
  cand_geometry(span, 1, &g);
  return g.nch > 1 ? 3 : 2;
}

// Bytes of scratch that detect_candidates_launch needs at this geometry
// (0 for the one-pass kernel).
extern "C" long long detect_candidates_scratch(int rows, int n_out, int lag,
                                               int span, int win,
                                               int n_seg) {
  if (cand_one_pass(lag, span, win)) return 0;
  CandGeometry g;
  cand_geometry(span, n_seg, &g);
  return cand_layout(rows, n_out, n_seg, g, nullptr, nullptr);
}

// ext: [rows, len] complex64 on the device; floors: [rows] float; n_out =
// len - span - lag + 1.  Outputs [rows, n_seg]: segval float, segarg
// int32, segcre/segcim float.  scratch: detect_candidates_scratch bytes on
// the device.  Returns the CUDA error code of the launches (0 = success;
// cudaErrorInvalidValue for arguments out of range, offsets past 2^31 or
// more shared memory than an SM has, cudaErrorInvalidConfiguration for
// more than 2^31 - 1 chunks).
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
  CandGeometry g;
  if (!cand_geometry(span, n_seg, &g)) return (int)cudaErrorInvalidValue;
  CandScratch sc;
  cand_layout(rows, n_out, n_seg, g, (char*)scratch, &sc);
  const long long tgrid = (long long)rows * (g.nblk + 1) * g.nch;
  const long long tiles = (long long)rows * g.nblk * g.nch;
  const long long total = (long long)rows * n_seg;
  const long long pgrid =
      (total + CAND_PICK_THREADS - 1) / CAND_PICK_THREADS;
  if (tgrid > 0x7fffffff || pgrid > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float2) * 2 * (size_t)w3_buf(lag, g.nch) +
                      sizeof(float) * (8 * W3_WARPS + CAND_SUMS_SMEM);
  long long grid = 0;
  cudaError_t err = w3_persistent_grid((const void*)cand_sums_kernel, smem,
                                       tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  const float2* x = (const float2*)ext;
  if (g.nch > 1) {
    w3_totals_kernel<0><<<(unsigned)tgrid, W3_THREADS, 0, st>>>(
        x, len, lag, span, g.ch, g.nch, (int)g.nblk + 1, sc.tot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cand_sums_kernel<<<(unsigned)grid, W3_THREADS, smem, st>>>(
      x, len, lag, span, g.ch, g.nch, (int)g.nblk, (unsigned)tiles,
      (const float*)floors, n_out, n_seg, win, T, thr, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cand_pick_kernel<<<(unsigned)pgrid, CAND_PICK_THREADS, 0, st>>>(
      x, len, lag, span, win, T, thr, n_out, n_seg, total, sc,
      (float*)segval, (int*)segarg, (float*)segcre, (float*)segcim);
  return (int)cudaGetLastError();
}
