// Order-free column reactions of the Newton-triangular sweeps (quadscan.cu,
// dotscan.cu). A block adds each force-sized f32 reaction it computes into
// an int64 fixed-point accumulator (2^32 units per kJ/mol/nm, range +-2^31)
// with integer atomics, which are exact and associative, so the order in
// which blocks run does not change the sum and two launches are bitwise
// equal. A second kernel adds the converted sums to the row sums.

#pragma once

#include <cuda_runtime.h>

namespace fixed_point {

constexpr float TO_FIXED = 4294967296.0f;  // 2^32 units per kJ/mol/nm
constexpr double FROM_FIXED = 1.0 / 4294967296.0;

// acc += v in fixed point (v rounded to the nearest unit)
__device__ __forceinline__ void add(unsigned long long* acc, float v) {
  atomicAdd(acc, static_cast<unsigned long long>(__float2ll_rn(v * TO_FIXED)));
}

namespace {

// out[i].yzw += the fixed-point column sums of atom i, acc (3, n_pad)
__global__ void add_columns(float4* __restrict__ out, const long long* __restrict__ acc, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  float4 o = out[i];
  o.y += static_cast<float>(static_cast<double>(acc[i]) * FROM_FIXED);
  o.z += static_cast<float>(static_cast<double>(acc[n_pad + i]) * FROM_FIXED);
  o.w += static_cast<float>(static_cast<double>(acc[2 * n_pad + i]) * FROM_FIXED);
  out[i] = o;
}

}  // namespace

// Launch add_columns over n_pad atoms on `stream`.
inline void launch_add_columns(float4* out, const void* acc, int n_pad, cudaStream_t stream) {
  add_columns<<<(n_pad + 255) / 256, 256, 0, stream>>>(out, static_cast<const long long*>(acc), n_pad);
}

}  // namespace fixed_point
