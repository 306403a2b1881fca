// Nearest-point scan of the payload codec and the candidate decode: for
// every point x[k, i] of every row k, the entry of the row's table that is
// nearest to it and its squared distance,
//
//   arg[k, i]  = argmin_c |x[k, i] - table[k, c]|^2  (first on ties),
//   best[k, i] = that minimum,
//
// in one launch for the whole [K, n] batch.
//
// Replaces no Pallas kernel.  The JAX package writes the scan as a
// lax.scan over chunks of 16 table entries with an unrolled running update
// (liquid_usrp_tpu/framing/payload.py :: _nearest_sym), which XLA fuses
// into one loop.  The port's eager form of it (framing/payload.py ::
// _nearest_sym_plain, the plain version beside this kernel) writes and
// reads a [K, n, 16] float32 tile for each of the 16 chunks of a 256-entry
// table, in 8-11 launches a chunk: some 150 launches and tens of ms of
// device time for one call at a loaded multichannel dispatch.
//
// What bounds it on this card: float32 operations.  A call compares every
// point with every entry (5 operations a pair: two subtractions, two
// products, a sum; then a compare and two selects), while it reads each
// point once (8 bytes) and writes 12 bytes a point: at 256 entries that is
// about 64 operations a byte, past the card's 20.  So the table sits in
// shared memory (at most 256 x 8 bytes), each entry a broadcast read, and
// each thread keeps kPts points and their running minima in registers
// while it walks the table once; nothing of size [K, n, C] is ever stored.
// One block holds kThreads x kPts points of one row; the grid is every
// (row, tile) pair, flattened.
//
// The decision rule is the plain version's, bit for bit:
// * d = (xr - tr)^2 + (xi - ti)^2 with each operation rounded on its own
//   (round-to-nearest intrinsics: no FMA contraction), as eager PyTorch
//   computes it;
// * the running minimum starts at best = 1e30, arg = 0, and takes entry c
//   only where d < best, in ascending c: the first minimum on ties, as the
//   plain version's argmin inside a chunk and strict < across chunks give;
// * a NaN distance never compares below, so a NaN point keeps (0, 1e30), as
//   does a point whose distances are all infinite or at least 1e30;
// * padding entries (1e6 + 0j) are scanned like any other.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPts = 4;                    // points a thread
constexpr int kTile = kThreads * kPts;     // points a block
constexpr int kMaxC = 256;                 // table entries a row, at most

__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float2* __restrict__ x, int n, int tiles,
               const float2* __restrict__ table, int C,
               long long* __restrict__ arg, float* __restrict__ best) {
  __shared__ float2 tab[kMaxC];
  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x - row * tiles;
  const float2* trow = table + (long long)row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) tab[c] = trow[c];

  // point j of this thread: tile * kTile + threadIdx.x + j * kThreads, so
  // a warp's loads and stores are contiguous
  const long long base = (long long)row * n;
  const int p0 = tile * kTile + threadIdx.x;
  float xr[kPts], xi[kPts], bm[kPts];
  int ba[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int p = p0 + j * kThreads;
    const float2 v = p < n ? x[base + p] : make_float2(0.f, 0.f);
    xr[j] = v.x;
    xi[j] = v.y;
    bm[j] = 1e30f;
    ba[j] = 0;
  }
  __syncthreads();

#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float2 t = tab[c];
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const float dr = __fsub_rn(xr[j], t.x);
      const float di = __fsub_rn(xi[j], t.y);
      const float d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
      if (d < bm[j]) {
        bm[j] = d;
        ba[j] = c;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const int p = p0 + j * kThreads;
    if (p < n) {
      arg[base + p] = ba[j];
      best[base + p] = bm[j];
    }
  }
}

}  // namespace

// x: [K, n] complex64 (interleaved float2), table: [K, C] complex64, both
// contiguous on the device, 1 <= C <= 256.  Outputs arg [K, n] int64 and
// best [K, n] float32.  K = 0 or n = 0 launches nothing.  Launches on
// ``stream`` and returns the CUDA error code of the launch (0 = success).
extern "C" int nearest_launch(const void* x, int K, int n, const void* table,
                              int C, void* arg, void* best, void* stream) {
  if (K < 0 || n < 0 || C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (!K || !n) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  const long long blocks = (long long)K * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  nearest_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, n, tiles, (const float2*)table, C, (long long*)arg,
      (float*)best);
  return (int)cudaGetLastError();
}
