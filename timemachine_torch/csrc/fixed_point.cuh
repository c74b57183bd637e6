// Order-free sums of the Newton-triangular sweeps: column reactions, and in
// rowscan.cu, nb_tiles.cu, gather.cu, quadscan.cu and dotscan.cu the row
// sums too (nb_tiles.cu its dU/dp columns). A block adds each force-sized
// f32 sum it computes into an int64 fixed-point accumulator (2^32 units per
// kJ/mol/nm, range +-2^31) with integer atomics, which are exact and
// associative, so the order in which blocks run does not change the sum
// and two launches are bitwise equal. A second kernel converts the sums
// (store_checked), or adds the converted column sums to f32 row sums
// (add_columns, quadscan.cu's first design).
//
// The sums are range-checked: a sum of FIX_LIMIT or more (half the
// accumulator's range), or not finite, raises a flag (add_checked) that
// turns the whole result into NaN, and a final sum beyond FIX_LIMIT comes
// back NaN too (store_checked), so a near-overlap gives NaN, never a
// wrapped finite sum (a sum wraps undetected only past 1.5 times the
// range).

#pragma once

#include <cuda_runtime.h>

namespace fixed_point {

constexpr float TO_FIXED = 4294967296.0f;  // 2^32 units per kJ/mol/nm
constexpr double FROM_FIXED = 1.0 / 4294967296.0;
constexpr float FIX_LIMIT = 1073741824.0f;      // 2^30 kJ/mol/nm: half the fixed-point range
constexpr long long FIX_LIMIT_RAW = 1LL << 62;  // FIX_LIMIT in fixed-point units

// acc += v in fixed point (v rounded to the nearest unit)
__device__ __forceinline__ void add(unsigned long long* acc, float v) {
  atomicAdd(acc, static_cast<unsigned long long>(__float2ll_rn(v * TO_FIXED)));
}

// acc += v in fixed point; a v of FIX_LIMIT or more, or not finite, raises the flag instead
__device__ __forceinline__ void add_checked(unsigned long long* acc, float v, unsigned long long* flag) {
  if (v == 0.0f) return;
  if (!(fabsf(v) < FIX_LIMIT)) {
    atomicOr(flag, 1ull);
    return;
  }
  add(acc, v);
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

// out[i] = the fixed-point sums of atom i, acc (4, n_pad) then the flag: NaN
// everywhere if the flag is up, NaN for a sum beyond FIX_LIMIT
__global__ void store_checked(float4* __restrict__ out, const long long* __restrict__ acc, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const bool flagged = acc[4 * static_cast<size_t>(n_pad)] != 0;
  auto to_float = [flagged](long long v) {
    return (flagged || v >= FIX_LIMIT_RAW || v <= -FIX_LIMIT_RAW) ? __int_as_float(0x7fc00000)
                                                                    : static_cast<float>(static_cast<double>(v) *
                                                                                         FROM_FIXED);
  };
  out[i] = make_float4(to_float(acc[i]), to_float(acc[n_pad + i]), to_float(acc[2 * n_pad + i]),
                       to_float(acc[3 * n_pad + i]));
}

}  // namespace

// Launch store_checked over n_pad atoms on `stream`; acc (4 n_pad + 1) with the flag last.
inline void launch_store_checked(float4* out, const void* acc, int n_pad, cudaStream_t stream) {
  store_checked<<<(n_pad + 255) / 256, 256, 0, stream>>>(out, static_cast<const long long*>(acc), n_pad);
}

// Launch add_columns over n_pad atoms on `stream`.
inline void launch_add_columns(float4* out, const void* acc, int n_pad, cudaStream_t stream) {
  add_columns<<<(n_pad + 255) / 256, 256, 0, stream>>>(out, static_cast<const long long*>(acc), n_pad);
}

}  // namespace fixed_point
