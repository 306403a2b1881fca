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
// What bounds the function on the card: device-memory traffic, 8 B read
// and 4 B written per output.  The S0 template repeats with period M/4;
// csrc/xcorr_fold.cu folds that period for every other periodic template,
// and this kernel runs M = 48's template and any template with no period
// (ops/kernels.py::xcorr_path chooses).  It runs the direct form, n_tmpl
// complex multiply-adds per output (96 at M=48, 4 FMAs each), and the
// design makes that loop FMA-bound:
//
// * Register tiling.  A thread computes XC_R consecutive outputs.  It keeps
//   a sliding window of 2 * XC_R samples in registers, so one shared-memory
//   load of a sample feeds XC_R outputs (4 * XC_R FMAs).  The taps, padded
//   per segment to a multiple of XC_R with zeros (a zero tap adds nothing),
//   sit in __constant__ memory: every lane reads the same tap in the same
//   step, which the constant cache broadcasts.
// * Bank conflicts.  XC_R consecutive outputs per thread make lanes read at
//   a stride of XC_R samples; the tile stores sample i at i + i / 8, so the
//   stride becomes 9 float2 and the lanes of a half warp hit distinct banks.
// * Segment energies.  E_s[n] = W[n + s*span], where W is the span-window
//   power sum, computed once per tile (register-tiled the same way) in the
//   plain version's order (|x|^2 rounded as x.re^2 + x.im^2, then summed
//   tap by tap), so the floor decisions equal the plain version's.
// * Wide tiles: XC_R * XC_THREADS = 2,048 outputs per block against a halo
//   of n_tmpl - 1 (+ padding) samples, staged with cp.async.  Results leave
//   through shared memory as coalesced stores.
// * Any template.  The template of M = 48 (4 segments of 24) is a template
//   instance whose taps are immediate __constant__ operands.  Every other
//   template reads its taps from a device buffer (the same tap in every
//   lane: one broadcast load from L1), and a block walks the segments in
//   passes of at most `gseg` segments, staging for each pass only the
//   samples and W offsets of those segments, so the staged tile stays
//   under XC_SMEM_BYTES at any M (2 M template samples, 1,024 segments at
//   M = 8,192).  Each output's sum over segments carries across passes in
//   registers.
//
// The floor per row is computed by the wrapper (ops/kernels.py) exactly as
// the JAX wrapper does.  Beyond the end of a row the stream reads as zero
// (the JAX wrapper's zero padding of a short row).
#include <cuda_runtime.h>

#include <cstring>

#define XC_R 8            // outputs per thread
#define XC_WR 9           // span-window power sums per thread (one pass)
#define XC_THREADS 256
#define XC_TO (XC_R * XC_THREADS)  // outputs per block
#define XC_SMEM_BYTES (100 * 1024)  // staged tile of one pass, at most
#define XC_CONST_TAPS 96  // padded taps of the __constant__ template
#define XC_CONST_SEG 4

__constant__ float c_tre[XC_CONST_TAPS];
__constant__ float c_tim[XC_CONST_TAPS];
__constant__ float c_ea[XC_CONST_SEG];

// Shared-memory slot of tile sample (or W offset) i: one pad slot per 8.
__host__ __device__ inline int xc_phys(int i) { return i + (i >> 3); }

// Staged samples and W offsets of one pass over g segments.
__host__ __device__ inline int xc_nx(int span, int g, int sp) {
  return XC_TO + (g - 1) * span + sp + 3 * XC_R + XC_WR;
}
__host__ __device__ inline int xc_nw(int span, int g) {
  return XC_TO + (g - 1) * span;
}
static size_t xc_smem(int span, int g) {
  const int sp = (span + XC_R - 1) / XC_R * XC_R;
  return sizeof(float) * (2 * (size_t)(xc_phys(xc_nx(span, g, sp)) + 1) +
                          (size_t)(xc_phys(xc_nw(span, g)) + 1));
}

__device__ inline float xc_power(float2 v) {  // as the plain version rounds
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// SPAN, NSEG > 0: the segment length and count of the __constant__
// template as compile-time constants (M = 48), so every tap loop unrolls,
// every tap is an immediate __constant__ operand of its FMA and one pass
// takes every segment; 0, 0: any template, its taps (unpadded, complex)
// and segment energies read from tmpl and ea, in passes of gseg_rt
// segments.
template <int SPAN, int NSEG>
__global__ void __launch_bounds__(XC_THREADS, 2)
xcorr_metric_kernel(const float2* __restrict__ ext, int len, int span_rt,
                    int n_seg_rt, int gseg_rt, int n_metric,
                    const float* __restrict__ floors,
                    const float2* __restrict__ tmpl,
                    const float* __restrict__ ea_d,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int span = SPAN ? SPAN : span_rt;
  const int n_seg = NSEG ? NSEG : n_seg_rt;
  const int gseg = NSEG ? NSEG : gseg_rt;
  const int sp = (span + XC_R - 1) / XC_R * XC_R;  // padded taps a segment
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * XC_TO;
  const float2* rp = ext + (long long)row * len;
  float macc[XC_R];
#pragma unroll
  for (int k = 0; k < XC_R; ++k) macc[k] = 0.f;

  for (int s0 = 0; s0 < n_seg; s0 += gseg) {
    const int g = n_seg - s0 < gseg ? n_seg - s0 : gseg;  // this pass
    const int nx = xc_nx(span, g, sp);
    const int nw = xc_nw(span, g);
    const int x0 = n0 + s0 * span;  // stream offset of staged sample 0
    float2* X = reinterpret_cast<float2*>(smem);  // xc_phys(nx) + 1
    float* W = smem + 2 * (xc_phys(xc_nx(span, gseg, sp)) + 1);

    // 1. Stage samples [x0, x0 + nx) with 8-byte cp.async copies; beyond
    //    the row end the copy reads nothing and fills zeros.
    for (int i = tid; i < nx; i += XC_THREADS) {
      const int gi = x0 + i;
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(X + xc_phys(i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                       dst),
                   "l"(rp + (gi < len ? gi : 0)), "r"(gi < len ? 8 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 2. W[q] = sum_{j<span} |x[q+j]|^2 for q < nw, XC_WR offsets a thread
    //    (one pass at the usual spans), summed tap by tap.
    for (int c = tid; c * XC_WR < nw; c += XC_THREADS) {
      const int b0 = c * XC_WR;
      float acc[XC_WR], p[XC_WR], p2[XC_WR];
#pragma unroll
      for (int k = 0; k < XC_WR; ++k) {
        acc[k] = 0.f;
        p[k] = xc_power(X[xc_phys(b0 + k)]);
      }
#pragma unroll
      for (int jb = 0; jb < span; jb += XC_WR) {
#pragma unroll
        for (int k = 0; k < XC_WR; ++k)
          p2[k] = xc_power(X[xc_phys(b0 + jb + XC_WR + k)]);
#pragma unroll
        for (int jj = 0; jj < XC_WR; ++jj) {
          if (jb + jj < span) {
#pragma unroll
            for (int k = 0; k < XC_WR; ++k)
              acc[k] = __fadd_rn(acc[k], jj + k < XC_WR
                                             ? p[jj + k]
                                             : p2[jj + k - XC_WR]);
          }
        }
#pragma unroll
        for (int k = 0; k < XC_WR; ++k) p[k] = p2[k];
      }
#pragma unroll
      for (int k = 0; k < XC_WR; ++k)
        if (b0 + k < nw) W[xc_phys(b0 + k)] = acc[k];
    }
    __syncthreads();

    // 3. The correlation of XC_R consecutive outputs per thread; with
    //    base = XC_R * tid, slot xc_phys(base + m) is 9 * tid + xc_phys(m).
    const float2* Xt = X + 9 * tid;
    const float* Wt = W + 9 * tid;
    const float floor_v = floors[row];
    // the register window: samples [o + jb, o + jb + 2 XC_R) of segment s
    // at tap block jb; the block after it is loaded one block ahead
    float2 w[XC_R], w2[XC_R];
#pragma unroll
    for (int s = 0; s < g; ++s) {
      const int o = s * span;
      const int sg = s0 + s;  // the segment of the template
      float ur[XC_R], ui[XC_R];
#pragma unroll
      for (int k = 0; k < XC_R; ++k) ur[k] = ui[k] = 0.f;
      // without padding the window of the last block runs on into the
      // next segment's first two blocks
      if (s == 0 || sp != span) {
#pragma unroll
        for (int k = 0; k < XC_R; ++k) {
          w[k] = Xt[xc_phys(o + k)];
          w2[k] = Xt[xc_phys(o + XC_R + k)];
        }
      }
#pragma unroll
      for (int jb = 0; jb < sp; jb += XC_R) {
        float2 w3[XC_R];
#pragma unroll
        for (int k = 0; k < XC_R; ++k)
          w3[k] = Xt[xc_phys(o + jb + 2 * XC_R + k)];
#pragma unroll
        for (int jj = 0; jj < XC_R; ++jj) {
          float tr, ti;
          if (NSEG) {
            tr = c_tre[sg * sp + jb + jj];
            ti = c_tim[sg * sp + jb + jj];
          } else {  // a zero tap past the segment's end adds nothing
            const float2 t = jb + jj < span
                                 ? __ldg(tmpl + sg * span + jb + jj)
                                 : make_float2(0.f, 0.f);
            tr = t.x;
            ti = t.y;
          }
#pragma unroll
          for (int k = 0; k < XC_R; ++k) {
            const float2 v = jj + k < XC_R ? w[jj + k] : w2[jj + k - XC_R];
            ur[k] = fmaf(tr, v.x, fmaf(ti, v.y, ur[k]));  // conj(t) * x
            ui[k] = fmaf(tr, v.y, fmaf(-ti, v.x, ui[k]));
          }
        }
#pragma unroll
        for (int k = 0; k < XC_R; ++k) {
          w[k] = w2[k];
          w2[k] = w3[k];
        }
      }
      const float ea = NSEG ? c_ea[sg] : __ldg(ea_d + sg);
#pragma unroll
      for (int k = 0; k < XC_R; ++k) {
        const float es = Wt[xc_phys(o + k)];
        const float r = __fdividef(ur[k] * ur[k] + ui[k] * ui[k],
                                   fmaxf(es * ea, 1e-12f));
        macc[k] += (es > floor_v) ? r : 0.f;
      }
    }
    __syncthreads();  // every thread is done with the staged samples
  }

  // 4. Results through shared memory, stored coalesced.
  float* ob = smem;
#pragma unroll
  for (int k = 0; k < XC_R; ++k)
    ob[9 * tid + k] = macc[k] / (float)n_seg;
  __syncthreads();
  float* orow = out + (long long)row * n_metric;
  for (int i = tid; i < XC_TO && n0 + i < n_metric; i += XC_THREADS)
    orow[n0 + i] = ob[xc_phys(i)];
}

typedef void (*XcKernel)(const float2*, int, int, int, int, int,
                         const float*, const float2*, const float*, float*);

// Host mirror of what __constant__ memory holds on each device, so the
// template of M = 48 is copied only when it changes.
static int g_dev = -1;
static float g_tre[XC_CONST_TAPS];
static float g_tim[XC_CONST_TAPS];
static float g_ea[XC_CONST_SEG];

// The M = 48 template (24 x 4) into __constant__ memory, each segment
// padded with zero taps to a multiple of XC_R, when it is not there.
static cudaError_t xc_const_template(const float* tre, const float* tim,
                                     const float* ea, cudaStream_t st) {
  const int span = 24, sp = 24, n_seg = XC_CONST_SEG;
  float h_tre[XC_CONST_TAPS], h_tim[XC_CONST_TAPS];
  memset(h_tre, 0, sizeof(h_tre));
  memset(h_tim, 0, sizeof(h_tim));
  for (int s = 0; s < n_seg; ++s) {
    memcpy(h_tre + s * sp, tre + s * span, sizeof(float) * span);
    memcpy(h_tim + s * sp, tim + s * span, sizeof(float) * span);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev == g_dev && !memcmp(h_tre, g_tre, sizeof(h_tre)) &&
      !memcmp(h_tim, g_tim, sizeof(h_tim)) &&
      !memcmp(ea, g_ea, sizeof(g_ea)))
    return cudaSuccess;
  err = cudaMemcpyToSymbolAsync(c_tre, h_tre, sizeof(h_tre), 0,
                                cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_tim, h_tim, sizeof(h_tim), 0,
                                  cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_ea, ea, sizeof(g_ea), 0,
                                  cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) {
    g_dev = -1;
    return err;
  }
  g_dev = dev;
  memcpy(g_tre, h_tre, sizeof(h_tre));
  memcpy(g_tim, h_tim, sizeof(h_tim));
  memcpy(g_ea, ea, sizeof(g_ea));
  return cudaSuccess;
}

// ext: [rows, len] complex64 (interleaved float pairs) on the device.
// tre/tim/ea: host arrays (n_tmpl, n_tmpl, n_tmpl / span floats); tmpl and
// ea_d: the same template (complex64) and energies on the device, which the
// M = 48 instance (span 24, 4 segments) does not read (null there).
// floors: [rows] float on the device.  out: [rows, n_metric] float.  Rows
// go in runs of the grid's y limit.  Returns the CUDA error code of the
// copies and the launches (0 = success).
extern "C" int xcorr_metric_launch(const void* ext, int rows, int len,
                                   const float* tre, const float* tim,
                                   const float* ea, const void* tmpl,
                                   const void* ea_d, int n_tmpl, int span,
                                   int n_metric, const void* floors,
                                   void* out, void* stream) {
  if (rows <= 0 || len <= 0 || span <= 0 || n_tmpl <= 0 ||
      n_tmpl % span != 0 || n_metric <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_seg = n_tmpl / span;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool fixed = span == 24 && n_seg == XC_CONST_SEG;
  if (!fixed && (tmpl == nullptr || ea_d == nullptr))
    return (int)cudaErrorInvalidValue;
  // segments a pass: all of them, or as many as the staged tile holds
  int gseg = n_seg;
  while (gseg > 1 && xc_smem(span, gseg) > XC_SMEM_BYTES) --gseg;
  if (xc_smem(span, gseg) > XC_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = fixed ? xc_const_template(tre, tim, ea, st) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const size_t smem = xc_smem(span, gseg);
  const XcKernel kern =
      fixed ? xcorr_metric_kernel<24, 4> : xcorr_metric_kernel<0, 0>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  for (int r0 = 0; err == cudaSuccess && r0 < rows; r0 += 65535) {
    const int nr = rows - r0 < 65535 ? rows - r0 : 65535;
    dim3 grid((n_metric + XC_TO - 1) / XC_TO, nr);
    kern<<<grid, XC_THREADS, smem, st>>>(
        (const float2*)ext + (long long)r0 * len, len, span, n_seg, gseg,
        n_metric, (const float*)floors + r0, (const float2*)tmpl,
        (const float*)ea_d, (float*)out + (long long)r0 * n_metric);
    err = cudaGetLastError();
  }
  return (int)err;
}
