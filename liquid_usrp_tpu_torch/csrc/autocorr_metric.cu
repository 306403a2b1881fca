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
// complex64 tensor on the host side).
//
// What bounds it on the card: the roof is device-memory traffic, 8 B read
// and 12 B written per output.  The design is the tile stage that kernel B2
// (detect_candidates.cu) also runs, in autocorr_tile.cuh: a block stages a
// tile of AC_TO outputs plus its span + lag - 1 halo in shared memory, forms
// the lag products there once, and each thread sums its outputs' span terms
// from shared memory.  Those span-long sums (4 shared-memory loads per term)
// are what limit this simple design, not device memory (PERF.md has the
// numbers).  The floor per row is computed by the wrapper (ops/kernels.py),
// as the JAX wrapper computes it.  No valid output reads the samples beyond
// the row end.
#include <cuda_runtime.h>

#include "autocorr_tile.cuh"

#define AC_TO 512       // outputs per block
#define AC_THREADS 256

__global__ void __launch_bounds__(AC_THREADS)
autocorr_metric_kernel(const float2* __restrict__ ext, int len, int lag,
                       int span, const float* __restrict__ floors, int n_out,
                       float* __restrict__ metric, float2* __restrict__ c) {
  extern __shared__ float sm[];
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * AC_TO;
  const AcTile t = ac_stage_tile(sm, ext + (long long)row * len, len, n0,
                                 AC_TO + span - 1, lag);
  const float floor_v = floors[row];
  const long long obase = (long long)row * n_out;
  for (int q = threadIdx.x; q < AC_TO && n0 + q < n_out; q += blockDim.x) {
    float2 cq;
    metric[obase + n0 + q] = ac_metric(t, q, span, lag, floor_v, cq);
    c[obase + n0 + q] = cq;
  }
}

// ext: [rows, len] complex64 on the device; floors: [rows] float.
// Outputs [rows, n_out]: metric float, c complex64 (float2).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int autocorr_metric_launch(const void* ext, int rows, int len,
                                      int lag, int span, const void* floors,
                                      int n_out, void* metric, void* c,
                                      void* stream) {
  if (rows <= 0 || rows > 65535 || lag <= 0 || span <= 0 || n_out <= 0 ||
      n_out != len - span - lag + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)ac_tile_floats(AC_TO + span - 1, lag);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(autocorr_metric_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_out + AC_TO - 1) / AC_TO, rows);
  autocorr_metric_kernel<<<grid, AC_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)ext, len, lag, span, (const float*)floors, n_out,
      (float*)metric, (float2*)c);
  return (int)cudaGetLastError();
}
