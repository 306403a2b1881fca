// The tile stage of the S0 periodicity (Schmidl-Cox) metric of kernel B3
// (autocorr_metric.cu; B2 has its own chunked stage in
// detect_candidates.cu):
//
//   c[m]  = sum_{i<span} x[m+i] * conj(x[m+i+lag])
//   e1[m] = sum_{i<span} |x[m+i]|^2,   e2[m] = e1[m+lag]
//   metric[m] = |c|^2 / max(e1*e2, 1e-12), or 0 unless min(e1, e2) > floor
//
// A block stages np + lag stream samples in shared memory as separate
// re/im/power planes and forms the np lag products there once; each thread
// then sums an offset's span terms from shared memory, in float32 and
// tile-local (no stream-long prefix sum, whose differences lose precision).
// Beyond the row end the stream repeats its last sample and before its start
// it reads zero, as the JAX wrappers pad.
#pragma once
#include <cuda_runtime.h>

// Shared-memory floats of the stage for np lag-product offsets.
__host__ __device__ inline int ac_tile_floats(int np, int lag) {
  return 3 * (np + lag) + 2 * np;
}

struct AcTile {
  const float* pw;   // |x|^2, np + lag
  const float* pr;   // Re x[i] * conj(x[i+lag]), np
  const float* pim;  // Im x[i] * conj(x[i+lag]), np
};

// Stages samples [m0, m0 + np + lag) of ``row`` (``len`` samples) into
// ``sm`` (ac_tile_floats(np, lag) floats) and forms the lag products; every
// thread of the block calls it.
__device__ inline AcTile ac_stage_tile(float* sm, const float2* __restrict__ row,
                                       int len, int m0, int np, int lag) {
  const int nx = np + lag;
  float* xr = sm;
  float* xi = xr + nx;
  float* pw = xi + nx;
  float* pr = pw + nx;
  float* pim = pr + np;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int g = m0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (g >= len)
      v = row[len - 1];
    else if (g >= 0)
      v = row[g];
    xr[i] = v.x;
    xi[i] = v.y;
    pw[i] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    // x[i] * conj(x[i+lag])
    const float ar = xr[i], ai = xi[i], br = xr[i + lag], bi = xi[i + lag];
    pr[i] = ar * br + ai * bi;
    pim[i] = ai * br - ar * bi;
  }
  __syncthreads();
  return AcTile{pw, pr, pim};
}

// The floor-gated metric at tile offset q; its lag correlation goes to c.
__device__ inline float ac_metric(const AcTile& t, int q, int span, int lag,
                                  float floor_v, float2& c) {
  float cre = 0.f, cim = 0.f, e1 = 0.f, e2 = 0.f;
  for (int i = 0; i < span; ++i) {
    cre += t.pr[q + i];
    cim += t.pim[q + i];
    e1 += t.pw[q + i];
    e2 += t.pw[q + lag + i];
  }
  c = make_float2(cre, cim);
  const float c2 = cre * cre + cim * cim;
  return (fminf(e1, e2) > floor_v) ? c2 / fmaxf(e1 * e2, 1e-12f) : 0.f;
}
