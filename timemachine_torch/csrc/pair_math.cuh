// The pair function shared by the sweeps of rowscan.cu, gather.cu,
// quadscan.cu and dotscan.cu: LJ + polynomial electrostatics on atom rows
// [x y z w q sigma/2 2 sqrt(eps) 0], the function of
// timemachine_tpu/ops/pallas/rowscan_kernel.py's pair tile.
//
// For a pair with imaged differences (dx, dy, dz), w offset difference dw
// and r2 = dx^2 + dy^2 + dz^2 + dw^2, inside the gate
// (r2 < cutoff^2) & (r2 > 1e-7):
//   energy   e4 t6 (t6 - 1) + qq h(t) / r,               t6 = (sigma_ij / r)^6
//   dU/dr/r  (e4 t6 (6 - 12 t6) + qq P(t) / r) / r^2,    t = 2 r / 1.2 - 1
// with e4 = 4 eps_ij and h, P degree-10 monomial series. Padding atoms carry
// q = eps = 0; `e4 * t6` is formed before any t6^2, so a zero eps zeroes
// what would otherwise be 0 * inf at r2 = 1e-8. Build without
// --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace pair_math {

constexpr int DEG = 11;                    // coefficients of the degree-10 series
constexpr float K1 = 1.6666666666666667f;  // t = K1 r - 1 = 2 r / 1.2 - 1

enum Mode { FORCE = 0, FORCE_ENERGY = 1, ENERGY = 2 };

struct Series {
  float h[DEG];  // energy h(t), low to high
  float p[DEG];  // force P(t) = u h'(u) - h(u)
};

// The series as a kernel parameter (constant bank), from two host arrays of DEG floats.
inline Series make_series(const float* h, const float* p) {
  Series s;
  for (int k = 0; k < DEG; ++k) {
    s.h[k] = h[k];
    s.p[k] = p[k];
  }
  return s;
}

__device__ __forceinline__ float horner(const float (&c)[DEG], float t) {
  float acc = c[DEG - 1];
#pragma unroll
  for (int k = DEG - 2; k >= 0; --k) acc = fmaf(acc, t, c[k]);
  return acc;
}

// (dU/dr / r, pair energy) of one pair at squared distance r2, both 0
// outside the gate or where `listed` is false. de_r is computed unless MODE
// is ENERGY, e unless MODE is FORCE; the other is left 0.
template <int MODE>
__device__ __forceinline__ void pair_terms_r2(float r2, float qq, float sg, float e4, float cut2, bool listed,
                                              const Series& s, float& de_r, float& e) {
  const float r2s = fmaxf(r2, 1e-8f);
  const float inv_r = rsqrtf(r2s);
  const float inv_r2 = inv_r * inv_r;
  const float s2 = sg * sg * inv_r2;
  const float t6 = s2 * s2 * s2;
  const float et6 = e4 * t6;
  const float t = K1 * (r2s * inv_r) - 1.0f;
  const bool gate = listed && (r2 < cut2) && (r2 > 1e-7f);
  de_r = 0.0f;
  e = 0.0f;
  if (MODE != ENERGY) {
    const float f = (et6 * (6.0f - 12.0f * t6) + qq * horner(s.p, t) * inv_r) * inv_r2;
    de_r = gate ? f : 0.0f;
  }
  if (MODE != FORCE) {
    const float en = et6 * (t6 - 1.0f) + qq * horner(s.h, t) * inv_r;
    e = gate ? en : 0.0f;
  }
}

// pair_terms_r2 with the 4D r2 of the differences (dx, dy, dz, dw)
template <int MODE>
__device__ __forceinline__ void pair_terms(float dx, float dy, float dz, float dw, float qq, float sg, float e4,
                                           float cut2, bool listed, const Series& s, float& de_r, float& e) {
  pair_terms_r2<MODE>(dx * dx + dy * dy + dz * dz + dw * dw, qq, sg, e4, cut2, listed, s, de_r, e);
}

}  // namespace pair_math
