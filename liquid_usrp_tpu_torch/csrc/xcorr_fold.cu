// Segmented-coherent S0 cross-correlation metric (kernel B1) for a
// template that repeats with period p: the period-fold path.
//
// Replaces, beside csrc/xcorr_metric.cu, the TPU kernel
// liquid_usrp_tpu/ops/pallas_kernels.py :: detect_metric_xcorr_onepass
// (body _xcorr1p_kernel) at every geometry but M = 48's.  It computes the
// function of csrc/xcorr_metric.cu:
//
//   u_s[n] = sum_{j<span} conj(t[s*span + j]) * x[n + s*span + j]
//   E_s[n] = sum_{j<span} |x[n + s*span + j]|^2
//   metric[n] = (1/n_seg) sum_s |u_s|^2 / max(E_s * ea_s, 1e-12),
//               the term 0 where E_s <= floor
//
// The fold.  The S0 template repeats with period p = M/4, so tap k of the
// template meets sample i in a product that depends only on i and
// (i - n) mod p.  Take a period P that p divides (P = p unless that would
// give more than XF_JMAX partial sums an output; then a multiple of p).
// Lane c walks one "diagonal": the products
//
//   Y_c[t] = conj(t[t mod p]) * x[c + t],   t < P + span - 1,
//
// and their span-window sums V_c[t] = sum_{q<span} Y_c[t + q], t < P.
// Segment s of output n is the window V_c[t] of lane c = n + j*P at
// t = s*span - j*P, j = floor(s*span / P): each output reads its n_seg
// windows from J = floor((n_tmpl - span) / P) + 1 lanes, and each window
// serves every output whose segment starts there (all J at once where span
// divides P; one where the alignments differ, as at M = 1,028).  The
// windows of partial j all start at offset o(j) = (-j P) mod span of a
// block of span, and the wrapper takes the fold only where every window
// at an offset serves the same set of j (so for every S0 template): a
// lane then sums its windows' metric terms per offset, in t order (s
// order), in registers, and writes partial j from offset o(j).
// xcorr_fold_sum_kernel adds each output's J partials in j order and
// divides by n_seg.  Every sum runs in an order fixed by the geometry,
// never by timing.
//
// Window sums in van Herk / Gil-Werman form, in registers: the walk goes
// in blocks of span products; a window that starts at offset o of block b
// is the suffix sum of block b from o plus the prefix sum of block b + 1
// up to o - 1.  Each holds only its own terms (no running sum across the
// walk, no subtraction), so a loud burst leaves no residue in the windows
// of the quiet samples after it.  The span-window powers E are summed tap
// by tap in the plain version's order (|x|^2 rounded as x.re^2 + x.im^2),
// so the floor decisions equal the plain version's.
//
// What bounds it on the card: float32 operations.  The fold does about p
// products a sample (4 FMAs), three window adds and, per needed window,
// the metric term, where the direct form does 2M complex multiply-adds per
// output.  Lanes are independent, so a row of n_metric outputs gives
// n_metric + (J - 1) P lanes: the app's windows at M = 1,028 fill 640
// blocks of 256 lanes, where the direct form's tiles filled about 80.
// Samples, taps, window metadata and the E sums of a block are staged in
// shared memory (samples by cp.async); lanes read consecutive samples and
// E values (conflict-free), and one tap and one metadata entry a step, the
// same in every lane (a broadcast).  The windows of a block of span are
// independent of each other, so with the span a compile-time constant
// (the S0 templates' 8, 16 and 24) a block is straight-line code whose
// loads and divides overlap; a test per window in that loop made the
// kernel latency-bound.  Where span divides P only offset 0 can serve,
// and only it is formed; elsewhere every offset is, and a window that
// serves no segment adds 0.
//
// Beyond the end of a row the stream reads as zero (the JAX wrapper's zero
// padding of a short row).  The floor per row comes from the wrapper
// (ops/kernels.py), as for csrc/xcorr_metric.cu.
#include <cuda_runtime.h>

#define XF_THREADS 256  // lanes a block
#define XF_MINB 2       // blocks an SM holds at least (register budget)
#define XF_JMAX 16      // partial sums an output, at most
#define XF_SPAN_MAX 24  // the largest span

__device__ inline float xf_power(float2 v) {  // as the plain version rounds
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// Shared-memory float2 slots of one block (samples, taps, metadata), then
// floats (E sums).  Metadata and E reach P + span window starts: the
// starts past P serve nothing (metadata 0), so a block of windows needs
// no bounds test.
__host__ __device__ inline int xf_nx(int P, int span) {
  return XF_THREADS + P + 2 * span;
}
static size_t xf_smem(int P, int span) {
  return sizeof(float2) * (size_t)(xf_nx(P, span) + (P + 2 * span) +
                                   (P + span)) +
         sizeof(float) * (size_t)(XF_THREADS + P + span);
}

// SPAN > 0: the span as a compile-time constant (8, 16 and 24, the S0
// templates' spans), so each block of span products and windows is
// straight-line code the compiler schedules as one; 0: any span up to
// XF_SPAN_MAX from span_rt, with a test per product and window.  ALIGNED:
// g = span (span divides P), so only the windows at offset 0 of a block
// serve, and they are block totals.  taps: [P + 2 span] conj template
// taps, tap t = conj(t[t mod p]) (zeros past P + span - 1).  meta: [P +
// span] per window start t: (ea of its segment, 1 if it serves a segment
// else 0).  part: [rows, J, n_metric].
template <int SPAN, bool ALIGNED>
__global__ void __launch_bounds__(XF_THREADS, XF_MINB)
xcorr_fold_kernel(const float2* __restrict__ ext, int len, int span_rt,
                  int P, int J, int n_metric, int n_lanes,
                  const float* __restrict__ floors,
                  const float2* __restrict__ taps,
                  const float2* __restrict__ meta,
                  float* __restrict__ part) {
  constexpr int SMAX = SPAN ? SPAN : XF_SPAN_MAX;
  const int span = SPAN ? SPAN : span_rt;
  extern __shared__ __align__(16) float2 sm2[];
  const int nx = xf_nx(P, span);
  const int nt = P + 2 * span;      // taps
  const int nm = P + span;          // metadata, E past the lanes
  float2* Xs = sm2;                 // samples c0 + [0, nx)
  float2* Ts = Xs + nx;             // taps [0, nt)
  float2* Ms = Ts + nt;             // metadata [0, nm)
  float* Es = reinterpret_cast<float*>(Ms + nm);  // E at c0 + [0, 256 + nm)
  const int lane = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * XF_THREADS;
  const float2* rp = ext + (long long)row * len;

  // 1. Stage the samples (zeros past the row end), the taps and the
  //    metadata with 8-byte cp.async copies, all in flight at once.
  for (int i = lane; i < nx; i += XF_THREADS) {
    const int gi = c0 + i;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(Xs + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(rp + (gi < len ? gi : 0)), "r"(gi < len ? 8 : 0)
                 : "memory");
  }
  for (int i = lane; i < nt + nm; i += XF_THREADS) {
    const float2* src = i < nt ? taps + i : meta + (i - nt);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(Ts + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. E at the block's positions, tap by tap as the plain version sums.
  for (int i = lane; i < XF_THREADS + nm; i += XF_THREADS) {
    float e = 0.f;
    for (int q = 0; q < span; ++q) e = __fadd_rn(e, xf_power(Xs[i + q]));
    Es[i] = e;
  }
  __syncthreads();

  // 3. The lane's walk: blocks of span products; the windows starting in
  //    block b - 1 once block b is known.
  const float floor_v = floors[row];
  const float2* X = Xs + lane;
  const float* E = Es + lane;
  const int nblk = (P + span - 1) / span + 1;
  float2 suf[SMAX];
  float acc[SMAX];  // the metric terms of the windows at each offset
#pragma unroll
  for (int q = 0; q < SMAX; ++q) {
    suf[q] = make_float2(0.f, 0.f);
    acc[q] = 0.f;
  }
  for (int b = 0; b < nblk; ++b) {
    const int t0 = b * span;
    float2 y[SMAX];
#pragma unroll
    for (int q = 0; q < SMAX; ++q) {
      if (SPAN || q < span) {
        const float2 tp = Ts[t0 + q], v = X[t0 + q];
        y[q] = make_float2(fmaf(tp.x, v.x, -tp.y * v.y),
                           fmaf(tp.x, v.y, tp.y * v.x));
      }
    }
    if (b > 0) {
      const int w0 = t0 - span;  // window starts w0 + o, o < span
      float2 pre = make_float2(0.f, 0.f);
#pragma unroll
      for (int o = 0; o < (ALIGNED ? 1 : SMAX); ++o) {
        if (SPAN || o < span) {
          if (o > 0) {
            pre.x += y[o - 1].x;
            pre.y += y[o - 1].y;
          }
          // a window that serves no segment adds 0, which is exact
          const float2 m = Ms[w0 + o];
          const float es = E[w0 + o];
          const float vr = o > 0 ? suf[o].x + pre.x : suf[0].x;
          const float vi = o > 0 ? suf[o].y + pre.y : suf[0].y;
          const float r =
              (m.y != 0.f && es > floor_v)
                  ? __fdividef(vr * vr + vi * vi, fmaxf(es * m.x, 1e-12f))
                  : 0.f;
          acc[o] += r;
        }
      }
    }
    // suffix sums of block b (the last product alone, then backwards)
#pragma unroll
    for (int q = SMAX - 1; q >= 0; --q) {
      if (SPAN || q < span) {
        float2 v = y[q];
        if (q + 1 < span) {  // then q + 1 < SMAX
          const int q1 = q + 1 < SMAX ? q + 1 : q;
          v.x += suf[q1].x;
          v.y += suf[q1].y;
        }
        suf[q] = v;
      }
    }
  }

  // 4. Partial j of lane c, the sum at offset (-j P) mod span, belongs to
  //    output c - j P.
  const int c = c0 + lane;
  if (c < n_lanes) {
    float* prow = part + (long long)row * J * n_metric;
    for (int j = 0; j < J; ++j) {
      const int n = c - j * P;
      const int oj = (span - j * P % span) % span;
      float v = 0.f;
#pragma unroll
      for (int o = 0; o < SMAX; ++o)
        if (o == oj) v = acc[o];
      if (n >= 0 && n < n_metric) prow[(long long)j * n_metric + n] = v;
    }
  }
}

// metric[n] = (sum_j part[j][n], j in order) / n_seg.
static __global__ void __launch_bounds__(XF_THREADS)
xcorr_fold_sum_kernel(const float* __restrict__ part, long long rows, int J,
                      int n_metric, int n_seg, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * XF_THREADS + threadIdx.x;
  if (i >= rows * n_metric) return;
  const long long row = i / n_metric;
  const float* p = part + row * J * n_metric + (i - row * n_metric);
  float s = 0.f;
  for (int j = 0; j < J; ++j) s += p[(long long)j * n_metric];
  out[i] = s / (float)n_seg;
}

typedef void (*XfKernel)(const float2*, int, int, int, int, int, int,
                         const float*, const float2*, const float2*, float*);

// The instance for a span: exact for 8, 16 and 24, else the runtime one.
static XfKernel xf_kernel(int span, bool aligned) {
  switch (span) {
    case 8: return aligned ? xcorr_fold_kernel<8, true>
                           : xcorr_fold_kernel<8, false>;
    case 16: return aligned ? xcorr_fold_kernel<16, true>
                            : xcorr_fold_kernel<16, false>;
    case 24: return aligned ? xcorr_fold_kernel<24, true>
                            : xcorr_fold_kernel<24, false>;
    default: return aligned ? xcorr_fold_kernel<0, true>
                            : xcorr_fold_kernel<0, false>;
  }
}

// ext: [rows, len] complex64; floors: [rows] float; taps [P + 2 span] and
// meta [P + span] as xcorr_fold_kernel takes them, on the device; part:
// rows * J * n_metric floats of scratch; out: [rows, n_metric] float.  g:
// gcd(P, span).  Rows go in runs of the grid's y limit.  Returns the CUDA
// error code of the launches (0 = success; cudaErrorInvalidValue for what
// it does not take).
extern "C" int xcorr_fold_launch(const void* ext, int rows, int len, int span,
                                 int n_seg, int P, int J, int g, int n_metric,
                                 const void* floors, const void* taps,
                                 const void* meta, void* part, void* out,
                                 void* stream) {
  if (rows <= 0 || len <= 0 || span <= 0 || span > XF_SPAN_MAX ||
      n_seg <= 0 || P <= 0 || J <= 0 || J > XF_JMAX || g <= 0 ||
      span % g != 0 || P % g != 0 || n_metric <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const XfKernel kern = xf_kernel(span, g == span);
  const size_t smem = xf_smem(P, span);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  const int n_lanes = n_metric + (J - 1) * P;
  for (int r0 = 0; err == cudaSuccess && r0 < rows; r0 += 65535) {
    const int nr = rows - r0 < 65535 ? rows - r0 : 65535;
    dim3 grid((n_lanes + XF_THREADS - 1) / XF_THREADS, nr);
    kern<<<grid, XF_THREADS, smem, st>>>(
        (const float2*)ext + (long long)r0 * len, len, span, P, J, n_metric,
        n_lanes, (const float*)floors + r0, (const float2*)taps,
        (const float2*)meta, (float*)part + (long long)r0 * J * n_metric);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)rows * n_metric;
  const long long grid = (total + XF_THREADS - 1) / XF_THREADS;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  xcorr_fold_sum_kernel<<<(unsigned)grid, XF_THREADS, 0, st>>>(
      (const float*)part, rows, J, n_metric, n_seg, (float*)out);
  return (int)cudaGetLastError();
}
