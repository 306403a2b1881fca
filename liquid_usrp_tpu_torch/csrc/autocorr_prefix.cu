// S0 periodicity metric from float32 prefix sums (kernels B4 and B5).
//
// Replaces the TPU kernels liquid_usrp_tpu/ops/pallas_kernels.py ::
// detect_metric_fused_2d (body _detect2d_kernel) and detect_metric_fused
// (body _detect_kernel).  The two differ only in their TPU layout (an
// (8, 128) raster vs 1024-sample tiles) and compute the same function of the
// same prefix arrays, so one kernel serves both wrappers.  Stage 1, the
// prefix sums, is plain PyTorch in the wrapper (ops/kernels.py), as it is
// XLA outside the Pallas body in JAX:
//
//   cre[k] = sum_{t<k} Re(x[t] conj(x[t+lag])),  cim likewise,
//   cp[k]  = sum_{t<k} |x[t]|^2.
//
// This kernel is stage 2, for every offset n < n_out of every row:
//
//   c[n]  = (cre[n+span] - cre[n]) + j (cim[n+span] - cim[n])
//   e1[n] = cp[n+span] - cp[n],   e2[n] = cp[n+span+lag] - cp[n+lag]
//   metric[n] = |c|^2 / max(e1*e2, 1e-12), or 0 unless min(e1, e2) > floor
//
// What bounds it on the card: device memory.  One thread per output makes
// eight coalesced 4-byte loads (most hit L2 or L1: neighbouring outputs
// share them) and 12 bytes of stores.  The arithmetic is written with
// round-to-nearest intrinsics, so it is not contracted into FMAs and gives
// the plain PyTorch version's numbers from the same prefix arrays.
#include <cuda_runtime.h>

#define AP_THREADS 256

__global__ void __launch_bounds__(AP_THREADS)
autocorr_prefix_kernel(const float* __restrict__ cre,
                       const float* __restrict__ cim,
                       const float* __restrict__ cp, int len, int lag,
                       int span, const float* __restrict__ floors,
                       int n_out, float* __restrict__ metric,
                       float2* __restrict__ c) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const int row = blockIdx.y;
  const float* pre = cre + (long long)row * (len - lag + 1);
  const float* pim = cim + (long long)row * (len - lag + 1);
  const float* pp = cp + (long long)row * (len + 1);
  const float dre = __fsub_rn(pre[n + span], pre[n]);
  const float dim = __fsub_rn(pim[n + span], pim[n]);
  const float e1 = __fsub_rn(pp[n + span], pp[n]);
  const float e2 = __fsub_rn(pp[n + span + lag], pp[n + lag]);
  const float c2 = __fadd_rn(__fmul_rn(dre, dre), __fmul_rn(dim, dim));
  const long long o = (long long)row * n_out + n;
  metric[o] = (fminf(e1, e2) > floors[row])
                  ? __fdiv_rn(c2, fmaxf(__fmul_rn(e1, e2), 1e-12f))
                  : 0.f;
  c[o] = make_float2(dre, dim);
}

// cre, cim: [rows, len - lag + 1], cp: [rows, len + 1] float on the device;
// floors: [rows] float.  Outputs [rows, n_out]: metric float, c complex64.
// Rows go in runs of the grid's y limit.  Returns the CUDA error code of
// the launches (0 = success).
extern "C" int autocorr_prefix_launch(const void* cre, const void* cim,
                                      const void* cp, int rows, int len,
                                      int lag, int span, const void* floors,
                                      int n_out, void* metric, void* c,
                                      void* stream) {
  if (rows <= 0 || lag <= 0 || span <= 0 || n_out <= 0 ||
      n_out != len - span - lag + 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  for (int r0 = 0; err == cudaSuccess && r0 < rows; r0 += 65535) {
    const int nr = rows - r0 < 65535 ? rows - r0 : 65535;
    const long long pc = (long long)r0 * (len - lag + 1);
    const long long o = (long long)r0 * n_out;
    dim3 grid((n_out + AP_THREADS - 1) / AP_THREADS, nr);
    autocorr_prefix_kernel<<<grid, AP_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)cre + pc, (const float*)cim + pc,
        (const float*)cp + (long long)r0 * (len + 1), len, lag, span,
        (const float*)floors + r0, n_out, (float*)metric + o,
        (float2*)c + o);
    err = cudaGetLastError();
  }
  return (int)err;
}
