// Terminated-trellis Viterbi decoder of the convolutional codes: the
// add-compare-select of every trellis step and the traceback from state 0,
// for every row, in one launch.
//
// Replaces no Pallas kernel.  The JAX package writes this trellis as a
// lax.scan (liquid_usrp_tpu/ops/conv.py:187-205), which XLA compiles into one
// loop on the device.  The port's eager form of that scan (ops/conv.py ::
// _viterbi_plain, the plain version beside this kernel) launches about four
// kernels a trellis step: some 66,000 for one 2,052-byte payload decode,
// whose host launch cost held nearly all of a --conv receiver's dispatch.
//
// Inputs: bm [rows, T, P] int32, the branch cost of every output pattern
// (P = 2^R) at every step; pidw [S/2] int32, one word a butterfly s'
// (predecessors 2s' and 2s'+1, successors s' and s'+S/2) holding the
// pattern ids of its four branches a byte each: s' <- 2s', s' <- 2s'+1,
// s'+S/2 <- 2s', s'+S/2 <- 2s'+1.  Output: bits [rows, T] uint8, the top bit
// of the state each step enters on the survivor path that ends in state 0.
//
// What bounds it on this card: neither bytes nor operations.  At the --conv
// receiver's shape (about 10 rows of T = 16,422 steps, S = 64) it reads 2.6
// MB of branch costs (under a microsecond at 3.35 TB/s) and does 10.5 M
// add-compare-selects; the limit is the chain of T dependent steps that
// each row is.  So a step has to be short:
// * S <= 256 (K = 7, 9): one warp a row.  Lane l owns the butterflies
//   l + 32 k and keeps the path metrics of the states l + 32 r in
//   registers; a step gathers its predecessors' metrics with __shfl_sync,
//   with no barrier.
// * S = 16,384 (K = 15): a block of 1,024 threads a row, 8 butterflies (16
//   states) a thread, the metrics double-buffered in shared memory, one
//   barrier a step.
// * Decisions: __ballot_sync packs the choices of 32 states into a word, in
//   the plain version's [2, S/2] order (bit ns of the step's S bits).  The
//   T x S/32 words stay in shared memory where they fit beside the rest,
//   else they go to a global scratch (viterbi_scratch gives its size).
// * Branch costs do not depend on the recurrence: cp.async brings the next
//   tile of steps into shared memory while the current tile runs.
// * Renormalisation: the row's least metric is subtracted at the end of
//   every tile.  Decisions depend only on differences within a row and the
//   int32 sums are exact, so the bits are those of any other interval.
// * Ties keep the first predecessor (a strict <: JAX's first-index argmin).
// * Traceback: one thread walks the decisions back from state 0; out of the
//   global scratch it walks tiles that cp.async stages in shared memory.
//   With S = 64 a step's two words are one 8-byte load whose address does
//   not depend on the state, so the walk's chain is a few integer ops.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpTile = 512;      // branch-cost ints a tile (warp rows)
constexpr int kBlockTile = 4096;    // ... (block rows)
constexpr int kBlockThreads = 1024;

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int S>
struct Geo {
  static constexpr bool kWarp = S <= 256;
  static constexpr int kThreads = kWarp ? 32 : kBlockThreads;
  static constexpr int kFly = S / 2 / kThreads;     // butterflies a thread
  static constexpr int kWords = S / 32;             // decision words a step
  static constexpr int kTile = kWarp ? kWarpTile : kBlockTile;
  // shared ints ahead of the decisions: the metrics' two buffers (block
  // rows), two tiles of branch costs, 32 for the block's least metric
  static constexpr int kFixed = (kWarp ? 0 : 2 * S) + 2 * kTile + 32;
  static constexpr int kTop = ilog2(S) - 1;         // the input bit's place
};

// Issues 4-byte cp.async copies of src[0, n) to dst[0, n) by the block's
// threads and commits them as one group (an empty one where n <= 0).
__device__ __forceinline__ void stage(int* dst, const int* src, long long n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + j);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every group but the newest, then for the block.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ int pid_of(int w, int j) {
  return (w >> (8 * j)) & 255;
}

// Walks steps t = hi - 1 down to lo (step t's words at dec[(t - base) W]),
// from the state s entered at step hi - 1; writes each step's bit and
// returns the state entered at step lo - 1.
template <int S>
__device__ int walk(const uint32_t* dec, int base, int hi, int lo, int s,
                    unsigned char* out) {
  constexpr int W = Geo<S>::kWords;
#pragma unroll 8
  for (int t = hi - 1; t >= lo; --t) {
    out[t] = (unsigned char)(s >> Geo<S>::kTop);
    uint32_t w;
    if constexpr (W == 2) {
      const uint2 v = reinterpret_cast<const uint2*>(dec)[t - base];
      w = (s & 32) ? v.y : v.x;
    } else {
      w = dec[(long long)(t - base) * W + (s >> 5)];
    }
    s = ((s << 1) & (S - 1)) | (int)((w >> (s & 31)) & 1u);
  }
  return s;
}

// The traceback of one row into out[0, T): straight out of shared memory
// (in_smem), else out of the global dec in tiles staged through buf
// (buf_ints of shared memory, two halves).
template <int S>
__device__ void traceback(const uint32_t* dec, bool in_smem, int* buf,
                          int buf_ints, int T, unsigned char* out) {
  constexpr int W = Geo<S>::kWords;
  __syncthreads();
  if (in_smem) {
    if (threadIdx.x == 0) walk<S>(dec, 0, T, 0, 0, out);
    return;
  }
  const int half = buf_ints / 2;
  const int ts = half / W;
  const int* g = reinterpret_cast<const int*>(dec);
  int hi = T, lo = T - ts > 0 ? T - ts : 0, s = 0;
  stage(buf, g + (long long)lo * W, (long long)(hi - lo) * W);
  for (int i = 0; hi > 0; ++i) {
    const int nlo = lo - ts > 0 ? lo - ts : 0;
    stage(buf + ((i + 1) & 1) * half, g + (long long)nlo * W,
          (long long)(lo - nlo) * W);
    staged();
    if (threadIdx.x == 0)
      s = walk<S>(reinterpret_cast<const uint32_t*>(buf + (i & 1) * half),
                  lo, hi, lo, s, out);
    __syncthreads();
    hi = lo;
    lo = nlo;
  }
}

// S <= 256: one warp a row.
template <int S>
__global__ void __launch_bounds__(32)
viterbi_warp_kernel(const int* __restrict__ bm, int T, int P,
                    const int* __restrict__ pidw, int big, int in_smem,
                    uint32_t* __restrict__ gdec,
                    unsigned char* __restrict__ bits) {
  using G = Geo<S>;
  constexpr int NF = G::kFly, NR = 2 * NF, W = G::kWords;
  extern __shared__ __align__(16) int smem[];
  int* tiles = smem;
  const long long row = blockIdx.x;
  uint32_t* dec = in_smem ? reinterpret_cast<uint32_t*>(smem + G::kFixed)
                          : gdec + row * T * W;
  const int* src = bm + row * T * P;
  const long long n = (long long)T * P;
  const int ts = G::kTile / P;
  const int lane = threadIdx.x;
  const int src0 = (2 * lane) & 31, src1 = src0 + 1;
  const bool hi = lane >= 16;
  int pw[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) pw[k] = pidw[lane + 32 * k];
  int pm[NR];                                 // state lane + 32 r
#pragma unroll
  for (int r = 0; r < NR; ++r) pm[r] = (r == 0 && lane == 0) ? 0 : big;

  stage(tiles, src, n < G::kTile ? n : G::kTile);
  for (int t0 = 0, i = 0; t0 < T; t0 += ts, ++i) {
    const long long next = (long long)(t0 + ts) * P;
    const long long left = n - next;
    stage(tiles + ((i + 1) & 1) * G::kTile, src + next,
          left < G::kTile ? left : G::kTile);
    staged();
    const int* cur = tiles + (i & 1) * G::kTile;
    const int te = T - t0 < ts ? T : t0 + ts;
#pragma unroll 4
    for (int t = t0; t < te; ++t) {
      const int* c = cur + (t - t0) * P;
      int np[NR];
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        // butterfly s' = lane + 32 k: state 2 s' is lane src0's register
        // 2 k + hi, state 2 s' + 1 lane src1's
        const int a0 = __shfl_sync(kFull, pm[2 * k], src0);
        const int a1 = __shfl_sync(kFull, pm[2 * k + 1], src0);
        const int b0 = __shfl_sync(kFull, pm[2 * k], src1);
        const int b1 = __shfl_sync(kFull, pm[2 * k + 1], src1);
        const int p0 = hi ? a1 : a0, p1 = hi ? b1 : b0;
        const int c00 = p0 + c[pid_of(pw[k], 0)];
        const int c01 = p1 + c[pid_of(pw[k], 1)];
        const int c10 = p0 + c[pid_of(pw[k], 2)];
        const int c11 = p1 + c[pid_of(pw[k], 3)];
        const bool d0 = c01 < c00, d1 = c11 < c10;
        np[k] = d0 ? c01 : c00;               // state s'
        np[k + NF] = d1 ? c11 : c10;          // state s' + S/2
        const uint32_t w0 = __ballot_sync(kFull, d0);
        const uint32_t w1 = __ballot_sync(kFull, d1);
        if (lane == k) mine = w0;
        if (lane == k + NF) mine = w1;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) pm[r] = np[r];
      if (lane < W) dec[(long long)t * W + lane] = mine;
    }
    int m = pm[0];
#pragma unroll
    for (int r = 1; r < NR; ++r) m = min(m, pm[r]);
    m = __reduce_min_sync(kFull, m);
#pragma unroll
    for (int r = 0; r < NR; ++r) pm[r] -= m;
    __syncwarp();
  }
  traceback<S>(dec, in_smem, tiles, 2 * G::kTile, T, bits + row * T);
}

// S > 256: a block of kBlockThreads a row; warp v owns the butterflies
// 32 (v NF + k) + lane, k < NF, so its decision words are two runs of NF.
template <int S>
__global__ void __launch_bounds__(kBlockThreads)
viterbi_block_kernel(const int* __restrict__ bm, int T, int P,
                     const int* __restrict__ pidw, int big, int in_smem,
                     uint32_t* __restrict__ gdec,
                     unsigned char* __restrict__ bits) {
  using G = Geo<S>;
  constexpr int NF = G::kFly, W = G::kWords, NT = kBlockThreads;
  extern __shared__ __align__(16) int smem[];
  int* pmb = smem;                            // [2][S]
  int* tiles = smem + 2 * S;                  // [2][kTile]
  int* least = tiles + 2 * G::kTile;          // [32]
  const long long row = blockIdx.x;
  uint32_t* dec = in_smem ? reinterpret_cast<uint32_t*>(smem + G::kFixed)
                          : gdec + row * T * W;
  const int* src = bm + row * T * P;
  const long long n = (long long)T * P;
  const int ts = G::kTile / P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int pw[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) pw[k] = pidw[32 * (warp * NF + k) + lane];
  for (int j = tid; j < S; j += NT) pmb[j] = j ? big : 0;

  stage(tiles, src, n < G::kTile ? n : G::kTile);
  for (int t0 = 0, i = 0; t0 < T; t0 += ts, ++i) {
    const long long next = (long long)(t0 + ts) * P;
    const long long left = n - next;
    stage(tiles + ((i + 1) & 1) * G::kTile, src + next,
          left < G::kTile ? left : G::kTile);
    staged();
    const int* cur = tiles + (i & 1) * G::kTile;
    const int te = T - t0 < ts ? T : t0 + ts;
    for (int t = t0; t < te; ++t) {
      const int* c = cur + (t - t0) * P;
      const int2* pin = reinterpret_cast<const int2*>(pmb + (t & 1) * S);
      int* pout = pmb + ((t + 1) & 1) * S;
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int sp = 32 * (warp * NF + k) + lane;
        const int2 p = pin[sp];
        const int c00 = p.x + c[pid_of(pw[k], 0)];
        const int c01 = p.y + c[pid_of(pw[k], 1)];
        const int c10 = p.x + c[pid_of(pw[k], 2)];
        const int c11 = p.y + c[pid_of(pw[k], 3)];
        const bool d0 = c01 < c00, d1 = c11 < c10;
        pout[sp] = d0 ? c01 : c00;
        pout[sp + S / 2] = d1 ? c11 : c10;
        const uint32_t w0 = __ballot_sync(kFull, d0);
        const uint32_t w1 = __ballot_sync(kFull, d1);
        if (lane == k) mine = w0;
        if (lane == k + NF) mine = w1;
      }
      if (lane < 2 * NF)
        dec[(long long)t * W + (lane < NF ? warp * NF + lane
                                          : S / 64 + warp * NF + lane - NF)] =
            mine;
      __syncthreads();
    }
    // the row's least metric, subtracted from every state
    int* pm = pmb + (te & 1) * S;
    int m = pm[tid];
    for (int j = tid + NT; j < S; j += NT) m = min(m, pm[j]);
    m = __reduce_min_sync(kFull, m);
    if (lane == 0) least[warp] = m;
    __syncthreads();
    m = __reduce_min_sync(kFull, least[lane]);
    for (int j = tid; j < S; j += NT) pm[j] -= m;
    __syncthreads();
  }
  traceback<S>(dec, in_smem, pmb, 2 * S, T, bits + row * T);
}

// Shared bytes of a launch: the fixed part and, where they fit beside it
// (opt-in limit of the current device), the decisions.  Returns the bytes
// and sets *in_smem; 0 on an error (*err set).
template <int S>
size_t smem_bytes(int T, bool* in_smem, cudaError_t* err) {
  int dev = 0, optin = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != cudaSuccess) return 0;
  const size_t fixed = sizeof(int) * (size_t)Geo<S>::kFixed;
  const size_t dec = sizeof(uint32_t) * (size_t)T * Geo<S>::kWords;
  *in_smem = fixed + dec <= (size_t)optin;
  return *in_smem ? fixed + dec : fixed;
}

template <int S>
long long scratch_bytes(int rows, int T) {
  bool in_smem = false;
  cudaError_t err;
  smem_bytes<S>(T, &in_smem, &err);
  if (err != cudaSuccess) return -1;
  return in_smem ? 0
                 : (long long)sizeof(uint32_t) * rows * T * Geo<S>::kWords;
}

template <int S>
int launch(const int* bm, int rows, int T, int P, const int* pidw, int big,
           uint32_t* scratch, unsigned char* bits, cudaStream_t st) {
  using G = Geo<S>;
  if (P > G::kTile) return (int)cudaErrorInvalidValue;
  bool in_smem = false;
  cudaError_t err;
  const size_t smem = smem_bytes<S>(T, &in_smem, &err);
  if (err != cudaSuccess) return (int)err;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  void (*kern)(const int*, int, int, const int*, int, int, uint32_t*,
               unsigned char*);
  if constexpr (G::kWarp)
    kern = viterbi_warp_kernel<S>;
  else
    kern = viterbi_block_kernel<S>;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<rows, G::kThreads, smem, st>>>(bm, T, P, pidw, big, in_smem ? 1 : 0,
                                         scratch, bits);
  return (int)cudaGetLastError();
}

bool valid(int rows, int T, int S, int P) {
  return rows > 0 && T > 0 && P > 0 && (P & (P - 1)) == 0 && P <= 256 &&
         (S == 64 || S == 256 || S == 16384);
}

}  // namespace

// Bytes of global scratch a launch needs for its decisions: 0 where they
// fit in shared memory, -1 for a geometry the kernel does not take (or a
// CUDA error).
extern "C" long long viterbi_scratch(int rows, int T, int S, int P) {
  if (!valid(rows, T, S, P)) return -1;
  switch (S) {
    case 64: return scratch_bytes<64>(rows, T);
    case 256: return scratch_bytes<256>(rows, T);
    default: return scratch_bytes<16384>(rows, T);
  }
}

// bm: [rows, T, P] int32, pidw: [S/2] int32, bits: [rows, T] uint8, all on
// the device; scratch: viterbi_scratch's bytes (null where that is 0).
// S = 64, 256 or 16,384 states; P = 2^R output patterns.  Launches on
// ``stream`` and returns the CUDA error code of the launch (0 = success).
extern "C" int viterbi_launch(const void* bm, int rows, int T, int S, int P,
                              const void* pidw, int big, void* scratch,
                              void* bits, void* stream) {
  if (!valid(rows, T, S, P)) return (int)cudaErrorInvalidValue;
  const int* b = (const int*)bm;
  const int* pw = (const int*)pidw;
  uint32_t* sc = (uint32_t*)scratch;
  unsigned char* out = (unsigned char*)bits;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 64: return launch<64>(b, rows, T, P, pw, big, sc, out, st);
    case 256: return launch<256>(b, rows, T, P, pw, big, sc, out, st);
    default: return launch<16384>(b, rows, T, P, pw, big, sc, out, st);
  }
}
