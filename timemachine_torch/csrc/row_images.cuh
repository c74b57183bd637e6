// Row-center images shared by dotscan.cu and rowscan.cu's preshift form.
//
// Each 32-atom row chunk has a periodic center c, quantized to CEN_SCALE nm
// (`rcen_q`, made by ops/dotscan_kernel.py::build_dotscan_tiles). A sweep
// maps every row atom and every column atom of a listed tile to its image
// nearest c, in coordinates relative to c, after which pairs subtract
// directly: that is the minimum image for every pair within the list
// cutoff as long as (largest periodic row half-extent) + cutoff < box / 2
// on every axis, which the builder rechecks at every rebuild. Every
// operation is rounded as written, so the plain PyTorch versions
// (rowscan_kernel._row_frame / _col_frame) give the same images.

#pragma once

#include <cuda_runtime.h>

namespace row_images {

constexpr float CEN_SCALE = 1e-4f;  // nm per unit of the quantized row centers

// (x - c) - b * rint((x - c) / b): a row atom's image nearest the center c
__device__ __forceinline__ float row_image(float x, float c, float b, float ib) {
  const float raw = __fsub_rn(x, c);
  return __fsub_rn(raw, __fmul_rn(b, rintf(__fmul_rn(raw, ib))));
}

// (x - c) + b * rint(c / b - x / b): a column atom's image nearest c, cb = c / b
__device__ __forceinline__ float col_image(float x, float c, float cb, float b, float ib) {
  return __fadd_rn(__fsub_rn(x, c), __fmul_rn(b, rintf(__fsub_rn(cb, __fmul_rn(x, ib)))));
}

// The center of row chunk `row` from rcen_q (n_rows, 4) in nm
__device__ __forceinline__ float3 center(const int* rcen_q, int row) {
  return make_float3(__fmul_rn(static_cast<float>(rcen_q[4 * row]), CEN_SCALE),
                     __fmul_rn(static_cast<float>(rcen_q[4 * row + 1]), CEN_SCALE),
                     __fmul_rn(static_cast<float>(rcen_q[4 * row + 2]), CEN_SCALE));
}

}  // namespace row_images
