// Segmented-coherent S0 cross-correlation metric (kernel B1).
//
// Replaces the TPU kernel liquid_usrp_tpu/ops/pallas_kernels.py ::
// detect_metric_xcorr_onepass (body _xcorr1p_kernel).  For every offset n
// of every row and every template segment s:
//
//   u_s[n] = sum_j conj(t[s*span + j]) * x[n + s*span + j]
//   E_s[n] = sum_j |x[n + s*span + j]|^2
//   r_s[n] = |u_s|^2 / max(E_s * ea_s, 1e-12), or 0 where E_s <= floor
//   metric[n] = mean_s r_s[n]
//
// What bounds it on the card: the roof is device-memory traffic.  Each
// output reads one complex64 sample (8 B) and writes one float (4 B); the
// 96 complex MACs per output at the default M=48 are far below the compute
// roof.  The design keeps every reuse on chip: a block stages its tile of
// the stream plus the (n_tmpl - 1)-sample halo once, as separate
// re/im/power planes in shared memory (consecutive threads read
// consecutive words, no bank conflicts), so the stream is read from device
// memory about once.  The template taps and segment energies sit in
// __constant__ memory: every thread of a warp reads the same tap in the
// same cycle, which the constant cache broadcasts.  One thread computes one
// output.  That costs 3 shared-memory loads per tap per output (about 290
// at M=48), and those loads, not device memory, limit this simple design:
// it runs well above the memory-traffic bound (PERF.md has the numbers).
//
// The floor per row is computed by the wrapper (ops/kernels.py) exactly as
// the JAX wrapper does.  Beyond the end of a row the stream reads as zero
// (the JAX wrapper's zero padding of a short row).
#include <cuda_runtime.h>

#include <cstring>

#define XC_TILE 256
#define XC_MAX_TMPL 2048
#define XC_MAX_SEG 256

__constant__ float c_tre[XC_MAX_TMPL];
__constant__ float c_tim[XC_MAX_TMPL];
__constant__ float c_ea[XC_MAX_SEG];

__global__ void __launch_bounds__(XC_TILE)
xcorr_metric_kernel(const float2* __restrict__ ext, int len, int n_tmpl,
                    int span, int n_seg, int n_metric,
                    const float* __restrict__ floors,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int width = XC_TILE + n_tmpl - 1;
  float* xr = smem;
  float* xi = xr + width;
  float* pw = xi + width;
  const int row = blockIdx.y;
  const long long base = (long long)row * len;
  const int n0 = blockIdx.x * XC_TILE;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int g = n0 + i;
    const float2 v = (g < len) ? ext[base + g] : make_float2(0.f, 0.f);
    xr[i] = v.x;
    xi[i] = v.y;
    pw[i] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int n = n0 + t;
  if (n >= n_metric) return;
  const float floor_v = floors[row];
  float acc = 0.f;
  for (int s = 0; s < n_seg; ++s) {
    const int o = s * span;
    float ure = 0.f, uim = 0.f, es = 0.f;
    for (int j = 0; j < span; ++j) {
      const float a = xr[t + o + j];
      const float b = xi[t + o + j];
      const float tr = c_tre[o + j];
      const float ti = c_tim[o + j];
      ure += tr * a + ti * b;  // conj(t) * x
      uim += tr * b - ti * a;
      es += pw[t + o + j];
    }
    const float r = (ure * ure + uim * uim) / fmaxf(es * c_ea[s], 1e-12f);
    acc += (es > floor_v) ? r : 0.f;
  }
  out[(long long)row * n_metric + n] = acc / (float)n_seg;
}

// Host mirror of what __constant__ memory holds on each device, so the
// template is copied only when it changes.
static int g_dev = -1;
static int g_n_tmpl = -1;
static int g_n_seg = -1;
static float g_tre[XC_MAX_TMPL];
static float g_tim[XC_MAX_TMPL];
static float g_ea[XC_MAX_SEG];

// ext: [rows, len] complex64 (interleaved float pairs) on the device.
// tre/tim/ea: host arrays (n_tmpl, n_tmpl, n_tmpl / span floats).
// floors: [rows] float on the device.  out: [rows, n_metric] float.
// Returns the CUDA error code of the copies and the launch (0 = success).
extern "C" int xcorr_metric_launch(const void* ext, int rows, int len,
                                   const float* tre, const float* tim,
                                   const float* ea, int n_tmpl, int span,
                                   int n_metric, const void* floors,
                                   void* out, void* stream) {
  if (rows <= 0 || len <= 0 || span <= 0 || n_tmpl <= 0 ||
      n_tmpl % span != 0 || n_tmpl > XC_MAX_TMPL ||
      n_tmpl / span > XC_MAX_SEG || n_metric <= 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_seg = n_tmpl / span;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const size_t tb = sizeof(float) * (size_t)n_tmpl;
  const size_t eb = sizeof(float) * (size_t)n_seg;
  if (dev != g_dev || n_tmpl != g_n_tmpl || n_seg != g_n_seg ||
      memcmp(tre, g_tre, tb) || memcmp(tim, g_tim, tb) ||
      memcmp(ea, g_ea, eb)) {
    err = cudaMemcpyToSymbolAsync(c_tre, tre, tb, 0,
                                  cudaMemcpyHostToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_tim, tim, tb, 0,
                                    cudaMemcpyHostToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_ea, ea, eb, 0,
                                    cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) {
      g_dev = -1;
      return (int)err;
    }
    g_dev = dev;
    g_n_tmpl = n_tmpl;
    g_n_seg = n_seg;
    memcpy(g_tre, tre, tb);
    memcpy(g_tim, tim, tb);
    memcpy(g_ea, ea, eb);
  }
  const size_t smem = sizeof(float) * 3 * (size_t)(XC_TILE + n_tmpl - 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(xcorr_metric_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_metric + XC_TILE - 1) / XC_TILE, rows);
  xcorr_metric_kernel<<<grid, XC_TILE, smem, st>>>(
      (const float2*)ext, len, n_tmpl, span, n_seg, n_metric,
      (const float*)floors, (float*)out);
  return (int)cudaGetLastError();
}
