// Rowscan pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rowscan_kernel` / `_rowscan_row_chunk` of
// timemachine_tpu/ops/pallas/rowscan_kernel.py in its symmetric-list mode,
// in all three of its modes: forces (every MD step), forces + energy (FIRE,
// stateless energy/force) and energy only (the barostat's two trial
// energies). Plain PyTorch version: rowscan_sweep_plain in
// timemachine_torch/ops/rowscan_kernel.py.
//
// What it computes, per row atom i: the sum over listed column atoms j with
// (r2 < cutoff^2) & (r2 > 1e-7) of
//   LJ  e4 t6 (t6 - 1),            e4 = 4 eps_ij, t6 = (sigma_ij / r)^6
//   ES  qq h(t) / r,               t = 2 r / 1.2 - 1, h a degree-10 monomial series
// and of its gradient (dU/dr / r) * (x_i - x_j), with minimum image and the
// 4D w lift. Atom rows are [x y z w q sigma/2 2 sqrt(eps) 0]; padding atoms
// carry q = eps = 0. Output per atom: [u_i, dU/dx_i] with u_i half of atom
// i's pair energies, since a symmetric list visits every pair from both ends.
//
// What bounds it on the card: arithmetic, not memory. At solvated DHFR
// (23,558 atoms, 744 row chunks of 32) the triangular TPU list sweeps 76-93M
// pair slots per step (the census in rowscan_kernel.py::suggest_cell_size);
// this symmetric list sweeps about twice that. Each slot costs one rsqrt
// (SFU) and about 45 FP32 instructions, most of them in the two 11-term
// Horner chains (h and P share t), while it reads 32 bytes per column atom
// from shared memory, broadcast to a whole warp.
//
// What the design does about it:
// * one block of 4 warps per 32-atom row chunk; lane l owns row atom l in
//   registers, warp w owns 32 of each column chunk's 128 atoms, so the inner
//   loop has no shuffles and every shared-memory read is a broadcast;
// * each listed 128-atom column chunk (4 KB) is staged in shared memory, and
//   the next one is fetched into registers while the current one is swept;
// * no atomics: each atom's sum lives in fixed threads and the 4 warps'
//   partial sums are added in a fixed order at the end, so a run is bitwise
//   reproducible. The price is twice the pair work of the Newton-triangular
//   TPU form;
// * only the pair gate is a select; padding pairs vanish arithmetically.
//   `e4 * t6` is formed before any t6^2, so a zero eps zeroes what would
//   otherwise be 0 * inf: build without --use_fast_math;
// * the series coefficients are kernel parameters (constant bank); box and
//   cutoff are read from a 4-float device array, so the host never syncs.
// Newton-triangular lists, wider tiles and tensor-core forms are left to
// measured later work.

#include <cuda_runtime.h>

#include "pair_math.cuh"

using namespace pair_math;

namespace {

constexpr int ROW = 32;   // atoms per row chunk
constexpr int COL = 128;  // atoms per column chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COLS_PER_WARP = COL / WARPS;

template <int MODE>
__global__ void __launch_bounds__(THREADS) rowscan_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const float* __restrict__ scal,  // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,        // (Npad) [u, dU/dx, dU/dy, dU/dz]
    const Series s) {
  __shared__ float4 tile[2 * COL];
  __shared__ float4 part[WARPS][ROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float cut2 = cutoff * cutoff;

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float u = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int start = row_start[row];
  const int count = row_count[row];

  float4 next0 = make_float4(0.f, 0.f, 0.f, 0.f), next1 = next0;
  if (count > 0) {
    const float4* c = atoms + static_cast<size_t>(col_ids[start]) * (2 * COL);
    next0 = c[threadIdx.x];
    next1 = c[threadIdx.x + THREADS];
  }
  for (int k = 0; k < count; ++k) {
    __syncthreads();  // every warp is done with the previous chunk
    tile[threadIdx.x] = next0;
    tile[threadIdx.x + THREADS] = next1;
    __syncthreads();
    if (k + 1 < count) {
      const float4* c = atoms + static_cast<size_t>(col_ids[start + k + 1]) * (2 * COL);
      next0 = c[threadIdx.x];
      next1 = c[threadIdx.x + THREADS];
    }
#pragma unroll 4
    for (int jj = 0; jj < COLS_PER_WARP; ++jj) {
      const int j = warp * COLS_PER_WARP + jj;
      const float4 ca = tile[2 * j];
      const float4 cb = tile[2 * j + 1];
      float dx = ra.x - ca.x;
      float dy = ra.y - ca.y;
      float dz = ra.z - ca.z;
      dx -= bx * rintf(dx * ibx);
      dy -= by * rintf(dy * iby);
      dz -= bz * rintf(dz * ibz);
      float de_r, e;
      pair_terms<MODE>(dx, dy, dz, ra.w - ca.w, rb.x * cb.x, rb.y + cb.y, rb.z * cb.z, cut2, true, s, de_r, e);
      if (MODE != ENERGY) {
        gx = fmaf(de_r, dx, gx);
        gy = fmaf(de_r, dy, gy);
        gz = fmaf(de_r, dz, gz);
      }
      if (MODE != FORCE) u += e;
    }
  }

  part[warp][lane] = make_float4(u, gx, gy, gz);
  __syncthreads();
  if (warp == 0) {
    float4 acc = part[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = part[w][lane];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    acc.x *= 0.5f;  // each pair's energy was counted from both of its atoms
    out[i] = acc;
  }
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_rows,) i32, col_ids i32,
// scal (4,) f32, out (Npad, 4) f32. h and p are host arrays of 11 floats.
// mode: 0 forces, 1 forces + energy, 2 energy. Returns cudaGetLastError().
extern "C" int rowscan_sweep_launch(const void* atoms, const void* row_start, const void* row_count,
                                    const void* col_ids, const void* scal, void* out, int n_rows, int mode,
                                    const float* h, const float* p, void* stream) {
  const Series s = make_series(h, p);
  const dim3 grid(n_rows), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* ci = static_cast<const int*>(col_ids);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  switch (mode) {
    case FORCE:
      rowscan_kernel<FORCE><<<grid, block, 0, st>>>(a, rs, rc, ci, sc, o, s);
      break;
    case FORCE_ENERGY:
      rowscan_kernel<FORCE_ENERGY><<<grid, block, 0, st>>>(a, rs, rc, ci, sc, o, s);
      break;
    case ENERGY:
      rowscan_kernel<ENERGY><<<grid, block, 0, st>>>(a, rs, rc, ci, sc, o, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
