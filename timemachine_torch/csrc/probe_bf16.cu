// bf16 vs f32 rate probe of the distance-and-gate sequence, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` of scripts/probe_bf16.py (:41, pallas_call
// :71): per element, in the working type (f32 or bf16), ITERS times
//   sh = (1 + t * 1e-3) rounded to the working type      (computed in f32)
//   dx = a - b sh,  dy = a sh - b,  dz = a - b
//   r2 = (dx dx + dy dy) + dz dz
//   acc = acc + (f32(r2) < cut2 ? 1 : 0)
// and out = f32(acc), the per-slot sequence a bf16 distance prefilter would
// run. Plain PyTorch version: bf16_rate_plain in
// timemachine_torch/probes/bf16_rate.py.
//
// What bounds it on the card: the vector pipes (ITERS * 10 operations per
// element against 12 bytes), by design. The question it answers is the
// rate ratio of packed bf16 (two elements per instruction) to f32.
//
// What the design does about it: one thread per element in f32, per pair
// of elements in bf16 (__nv_bfloat162); every operation rounds to the
// working type by an explicit intrinsic (__fmul_rn / __fsub_rn / __fadd_rn,
// __hmul2_rn / __hsub2_rn / __hadd2_rn), so no multiply-add contracts into
// an FMA and the plain version matches bit for bit. The compare is in f32,
// as in the TPU script.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float shift(int t) { return __fadd_rn(1.0f, __fmul_rn(static_cast<float>(t), 1e-3f)); }

__global__ void __launch_bounds__(256) gate_f32(const float* __restrict__ a, const float* __restrict__ b,
                                                float* __restrict__ out, int n, int iters, float cut2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float av = a[i], bv = b[i];
  float acc = 0.0f;
  for (int t = 0; t < iters; ++t) {
    const float sh = shift(t);
    const float dx = __fsub_rn(av, __fmul_rn(bv, sh));
    const float dy = __fsub_rn(__fmul_rn(av, sh), bv);
    const float dz = __fsub_rn(av, bv);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    acc = __fadd_rn(acc, r2 < cut2 ? 1.0f : 0.0f);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(256) gate_bf16(const float2* __restrict__ a, const float2* __restrict__ b,
                                                 float2* __restrict__ out, int n2, int iters, float cut2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 av = __float22bfloat162_rn(a[i]);
  const __nv_bfloat162 bv = __float22bfloat162_rn(b[i]);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f), zero = __float2bfloat16_rn(0.0f);
  __nv_bfloat162 acc = __bfloat162bfloat162(zero);
  for (int t = 0; t < iters; ++t) {
    const __nv_bfloat162 sh = __bfloat162bfloat162(__float2bfloat16_rn(shift(t)));
    const __nv_bfloat162 dx = __hsub2_rn(av, __hmul2_rn(bv, sh));
    const __nv_bfloat162 dy = __hsub2_rn(__hmul2_rn(av, sh), bv);
    const __nv_bfloat162 dz = __hsub2_rn(av, bv);
    const __nv_bfloat162 r2 = __hadd2_rn(__hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)), __hmul2_rn(dz, dz));
    const float2 rf = __bfloat1622float2(r2);
    acc = __hadd2_rn(acc, __halves2bfloat162(rf.x < cut2 ? one : zero, rf.y < cut2 ? one : zero));
  }
  out[i] = __bfloat1622float2(acc);
}

}  // namespace

// Launch the probe over n elements on `stream`: a, b, out (n,) f32 device
// pointers; bf16 != 0 takes the packed bf16 kernel (n even). Returns
// cudaGetLastError().
extern "C" int gate_rate_launch(const void* a, const void* b, void* out, int n, int iters, float cut2, int bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (n % 2) return static_cast<int>(cudaErrorInvalidValue);
    const int n2 = n / 2;
    gate_bf16<<<(n2 + 255) / 256, 256, 0, st>>>(static_cast<const float2*>(a), static_cast<const float2*>(b),
                                                static_cast<float2*>(out), n2, iters, cut2);
  } else {
    gate_f32<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                              static_cast<float*>(out), n, iters, cut2);
  }
  return static_cast<int>(cudaGetLastError());
}
