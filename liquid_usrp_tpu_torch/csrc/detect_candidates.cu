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
// runs lax.top_k after its kernel.
//
// What bounds it on the card: the roof is device-memory traffic.  Each
// output reads one complex64 sample (8 B); the full-rate metric and
// correlation never leave the chip and only 16 B per 64 outputs are
// written.  The design stages a tile of CAND_TO outputs plus its halo (win
// before; win + span + lag - 1 after) in shared memory with the tile stage
// that kernel B3 also runs (autocorr_tile.cuh), computes the metric for the
// tile and both NMS margins in shared memory, then lets each warp reduce one
// segment with shuffles.  Its window sums (4 loads per sample of the span)
// and the 2*win+1 NMS max are shared-memory loads per output, and they, not
// device memory, limit this simple design (PERF.md has the numbers).
#include <cuda_runtime.h>

#include "autocorr_tile.cuh"

#define CAND_TO 512       // outputs per block (8 segments)
#define CAND_SEG 64       // outputs per reduced segment
#define CAND_THREADS 256  // 8 warps: one segment each

__global__ void __launch_bounds__(CAND_THREADS)
detect_candidates_kernel(const float2* __restrict__ ext, int len, int lag,
                         int span, int win, int T, float thr,
                         const float* __restrict__ floors, int n_out,
                         int n_seg, float* __restrict__ segval,
                         int* __restrict__ segarg,
                         float* __restrict__ segcre,
                         float* __restrict__ segcim) {
  extern __shared__ float sm[];
  const int nm = CAND_TO + 2 * win;  // metric offsets [n0-win, n0+TO+win)
  const int np = nm + span - 1;      // lag-product / power offsets
  float* met = sm + ac_tile_floats(np, lag);
  float* cr = met + nm;
  float* ci = cr + CAND_TO;

  const int row = blockIdx.y;
  const int n0 = blockIdx.x * CAND_TO;
  const int m0 = n0 - win;  // stream offset of met[0]
  const AcTile t =
      ac_stage_tile(sm, ext + (long long)row * len, len, m0, np, lag);
  const float floor_v = floors[row];
  for (int q = threadIdx.x; q < nm; q += blockDim.x) {
    float2 cq;
    met[q] = ac_metric(t, q, span, lag, floor_v, cq);
    const int j = q - win;
    if (j >= 0 && j < CAND_TO) {
      cr[j] = cq.x;
      ci[j] = cq.y;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = (n0 / CAND_SEG) + warp;
  float best_v = -2.f;
  int best_j = 0;
  for (int h = 0; h < 2; ++h) {  // lanes cover the segment's two halves
    const int j = warp * CAND_SEG + h * 32 + lane;  // output index in tile
    const int n = n0 + j;
    const float mv = met[j + win];
    float lmax = met[j];
    for (int w = 1; w <= 2 * win; ++w) lmax = fmaxf(lmax, met[j + w]);
    const bool ok = (mv >= lmax) && (mv > thr) && (n >= win) &&
                    (n < T + win) && (n < n_out);
    const float s = ok ? mv : -1.f;
    if (s > best_v) {  // h = 0 comes first: ties keep the lower offset
      best_v = s;
      best_j = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov > best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
    }
  }
  if (lane == 0 && seg < n_seg) {
    const long long o = (long long)row * n_seg + seg;
    segval[o] = best_v;
    segarg[o] = n0 + best_j;
    segcre[o] = cr[best_j];
    segcim[o] = ci[best_j];
  }
}

// ext: [rows, len] complex64 on the device; floors: [rows] float.
// Outputs [rows, n_seg]: segval float, segarg int32, segcre/segcim float.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int detect_candidates_launch(const void* ext, int rows, int len,
                                        int lag, int span, int win, int T,
                                        float thr, const void* floors,
                                        int n_out, int n_seg, void* segval,
                                        void* segarg, void* segcre,
                                        void* segcim, void* stream) {
  if (rows <= 0 || len <= 0 || lag <= 0 || span <= 0 || win < 0 ||
      n_out <= 0 || n_seg <= 0 || (long long)n_seg * CAND_SEG < n_out ||
      rows > 65535)
    return (int)cudaErrorInvalidValue;
  const int nm = CAND_TO + 2 * win;
  const size_t smem =
      sizeof(float) *
      (size_t)(ac_tile_floats(nm + span - 1, lag) + nm + 2 * CAND_TO);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(detect_candidates_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_seg * CAND_SEG + CAND_TO - 1) / CAND_TO, rows);
  detect_candidates_kernel<<<grid, CAND_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const float2*)ext, len, lag, span, win, T, thr, (const float*)floors,
      n_out, n_seg, (float*)segval, (int*)segarg, (float*)segcre,
      (float*)segcim);
  return (int)cudaGetLastError();
}
