// FP32 peak probe for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of scripts/probe_mfu.py (:53,
// pallas_call :68), the probe behind the rowscan roofline: four
// cross-coupled FMA chains per element,
//   a1 = a0 m1, a2 = a0 m2, a3 = a0 m3
//   INNER times:  (a0, a1, a2, a3) <- (a0 a1 + c, a1 a2 + c, a2 a3 + c, a3 a0 + c)
//   out = ((a0 + a1) + a2) + a3
// Plain PyTorch version: fp32_peak_plain in
// timemachine_torch/probes/fp32_peak.py.
//
// What bounds it on the card: the FP32 pipes, by design: 4 * INNER FMAs per
// element against 8 bytes read and written. The TPU version was folded by
// its compiler (its time did not grow with INNER); here INNER, the
// multipliers and c are kernel arguments, so nvcc cannot fold the loop, and
// the caller checks that the time doubles with INNER.
//
// What the design does about it: one thread per element, so every thread
// carries 4 independent chains (each step's four FMAs depend only on the
// previous step) and 2M elements keep every SM full; fmaf is one rounding,
// __fmul_rn and __fadd_rn keep the other operations from contracting, so the
// plain version can match bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) fma_chains(const float* __restrict__ x, float* __restrict__ out, int n,
                                                  int inner, float m1, float m2, float m3, float c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a0 = x[i];
  float a1 = __fmul_rn(a0, m1);
  float a2 = __fmul_rn(a0, m2);
  float a3 = __fmul_rn(a0, m3);
#pragma unroll 8
  for (int k = 0; k < inner; ++k) {
    const float t0 = fmaf(a0, a1, c);
    const float t1 = fmaf(a1, a2, c);
    const float t2 = fmaf(a2, a3, c);
    const float t3 = fmaf(a3, a0, c);
    a0 = t0;
    a1 = t1;
    a2 = t2;
    a3 = t3;
  }
  out[i] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
}

}  // namespace

// Launch the probe over n elements on `stream`. Device pointers: x and out
// (n,) f32. Returns cudaGetLastError().
extern "C" int fma_chains_launch(const void* x, void* out, int n, int inner, float m1, float m2, float m3, float c,
                                 void* stream) {
  fma_chains<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, inner, m1, m2, m3, c);
  return static_cast<int>(cudaGetLastError());
}
