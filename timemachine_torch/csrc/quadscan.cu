// Quadscan pair sweep for NVIDIA Hopper (sm_90a): the port's first
// Newton-triangular sweep.
//
// Replaces the TPU kernel `_quadscan_kernel` of
// timemachine_tpu/ops/pallas/quadscan_kernel.py (the MD provider of the
// `kernel="quad"` configuration), in its two modes: forces (every MD step)
// and forces + energy (the barostat's trial energies). Plain PyTorch
// version: quadscan_sweep_plain in timemachine_torch/ops/quadscan_kernel.py.
//
// What it computes: Hilbert-sorted atoms in 32-atom chunks, each chunk both
// a row chunk and a column quarter. Row chunk r lists the quarters c >= r
// within the list cutoff, its own first, each entry carrying the image shift
// to add to the quarter's coordinates (one shift is right for every pair of
// the entry; the builder checks the invariant). Each pair within the cutoff
// is visited once, with the pair function of pair_math.cuh and no per-pair
// minimum image; on the diagonal entry only row atom < column atom. The row
// atom gets the energy (row-side u) and the gradient, the column atom the
// reaction. Output per atom: [u_i, dU/dx_i].
//
// What bounds it on the card: arithmetic, and the reduction of the column
// reactions. At solvated DHFR (744 chunks, about 17,200 listed tiles of 4
// quarters at cutoff + skin) a sweep has about 70M pair slots, half of a
// symmetric list's, each one rsqrt and about 45 FP32 instructions. The TPU
// kernel carries the column reactions across its sequential grid in one
// VMEM array (read-modify-write per quarter); a card runs its blocks in
// parallel and in no order, so nothing carries.
//
// What the design does about it:
// * one block of 4 warps per row chunk; warp w takes quarter w of every
//   listed tile. Lane l holds row atom l; the entry's 32 column atoms are
//   loaded one per lane (shifted at load time) and rotate through the warp
//   by __shfl_sync, one lane a step, carrying their reaction sums. After 32
//   steps every lane has met every column atom once, and each column atom
//   and its complete sum over the row chunk are back in the lane they
//   started from. No shared memory in the inner loop;
// * row sums stay in registers across a warp's entries and the 4 warps'
//   partials are added in a fixed order; each entry's column sums go into
//   fixed_point.cuh's int64 accumulator (2^32 units per kJ/mol/nm) by
//   order-free integer atomics, added to the row sums by a second kernel.
//   Two launches are bitwise equal, with no float atomics;
// * padding entries (the builder's last quarter, all padding) are computed
//   like any other, as the plain version computes them: padding atoms carry
//   q = eps = 0 and add exact zeros, and an entry that holds real atoms is
//   never dropped, whatever the caller's lists.

#include <cuda_runtime.h>

#include "fixed_point.cuh"
#include "pair_math.cuh"

using namespace pair_math;

namespace {

constexpr int Q = 32;     // atoms per row chunk and per column quarter
constexpr int PACK = 4;   // quarters per listed tile
constexpr int WARPS = PACK;
constexpr int THREADS = WARPS * 32;
constexpr int SHIFT_BITS = 12;  // quarter id in bits 0-11, (shift + 1) per axis in bits 12-17
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float image(int code, int axis) {
  return static_cast<float>(((code >> (SHIFT_BITS + 2 * axis)) & 3) - 1);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) quadscan_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count,  // in tiles of PACK entries
    const int* __restrict__ entries,
    const float* __restrict__ scal,            // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,                  // (Npad) row parts [u, dU/dx, dU/dy, dU/dz]
    unsigned long long* __restrict__ acc,      // (3, Npad) fixed-point column parts, zeroed
    int n_rows, const Series s) {
  __shared__ float4 part[WARPS][Q];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * Q + lane;
  const int n_pad = n_rows * Q;

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float cut2 = cutoff * cutoff;

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float u = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int* list = entries + static_cast<size_t>(row_start[row]) * PACK;
  const int n_entries = row_count[row] * PACK;
  for (int k = warp; k < n_entries; k += WARPS) {
    const int code = list[k];
    const int cid = code & ((1 << SHIFT_BITS) - 1);
    const bool diag = cid == row;
    const int j = cid * Q + lane;
    const float4 ca = atoms[2 * j];
    const float4 cb = atoms[2 * j + 1];
    float cx = ca.x + image(code, 0) * bx;
    float cy = ca.y + image(code, 1) * by;
    float cz = ca.z + image(code, 2) * bz;
    float cw = ca.w, cq = cb.x, cs = cb.y, ce = cb.z;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;  // reaction on the column atom this lane holds
#pragma unroll 8
    for (int step = 0; step < Q; ++step) {
      const int src = (lane + step) & (Q - 1);  // the lane the held column atom started in
      const float dx = ra.x - cx;
      const float dy = ra.y - cy;
      const float dz = ra.z - cz;
      float de_r, e;
      pair_terms<MODE>(dx, dy, dz, ra.w - cw, rb.x * cq, rb.y + cs, rb.z * ce, cut2, !diag || lane < src, s, de_r,
                       e);
      const float tx = de_r * dx, ty = de_r * dy, tz = de_r * dz;
      gx += tx;
      gy += ty;
      gz += tz;
      fx -= tx;
      fy -= ty;
      fz -= tz;
      if (MODE == FORCE_ENERGY) u += e;
      // pass the column atom and its reaction sum one lane down
      const int from = (lane + 1) & (Q - 1);
      cx = __shfl_sync(FULL, cx, from);
      cy = __shfl_sync(FULL, cy, from);
      cz = __shfl_sync(FULL, cz, from);
      cw = __shfl_sync(FULL, cw, from);
      cq = __shfl_sync(FULL, cq, from);
      cs = __shfl_sync(FULL, cs, from);
      ce = __shfl_sync(FULL, ce, from);
      fx = __shfl_sync(FULL, fx, from);
      fy = __shfl_sync(FULL, fy, from);
      fz = __shfl_sync(FULL, fz, from);
    }
    // 32 passes later lane l holds column atom j again, with its whole sum
    fixed_point::add(acc + j, fx);
    fixed_point::add(acc + n_pad + j, fy);
    fixed_point::add(acc + 2 * n_pad + j, fz);
  }

  part[warp][lane] = make_float4(u, gx, gy, gz);
  __syncthreads();
  if (warp == 0) {
    float4 sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = part[w][lane];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    out[i] = sum;
  }
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`, then the column
// pass. Device pointers: atoms (Npad, 8) f32, row_start/row_count (n_rows,)
// i32, entries i32, scal (4,) f32, out (Npad, 4) f32, acc (3, Npad) i64 set
// to zero. h and p are host arrays of 11 floats. mode: 0 forces, 1 forces +
// energy. Returns cudaGetLastError().
extern "C" int quadscan_sweep_launch(const void* atoms, const void* row_start, const void* row_count,
                                     const void* entries, const void* scal, void* out, void* acc, int n_rows, int mode,
                                     const float* h, const float* p, void* stream) {
  const Series s = make_series(h, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* en = static_cast<const int*>(entries);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  switch (mode) {
    case FORCE:
      quadscan_kernel<FORCE><<<n_rows, THREADS, 0, st>>>(a, rs, rc, en, sc, o, ac, n_rows, s);
      break;
    case FORCE_ENERGY:
      quadscan_kernel<FORCE_ENERGY><<<n_rows, THREADS, 0, st>>>(a, rs, rc, en, sc, o, ac, n_rows, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_add_columns(o, acc, n_rows * Q, st);
  return static_cast<int>(cudaGetLastError());
}
