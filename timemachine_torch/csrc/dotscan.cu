// Dotscan pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_dotscan_kernel` of
// timemachine_tpu/ops/pallas/dotscan_kernel.py (pallas_call :316 symmetric,
// :332 triangular), the MD provider of the `kernel="dot"` configuration, in
// its two modes: forces (every MD step) and forces + energy (the barostat's
// trial energies). Plain PyTorch version: dotscan_sweep_plain in
// timemachine_torch/ops/dotscan_kernel.py.
//
// What it computes: rowscan lists (32-atom row chunks, 128-atom column
// chunks) with a quantized periodic center per row chunk. Every row atom and
// every column atom of a listed tile is mapped to its image nearest the row
// chunk's center, so pairs subtract directly (the builder checks that this
// is the minimum image for every pair within the cutoff). r2 comes from
// those direct differences in both modes, self-pair gate r2 > 1e-7, as in
// the TPU kernel's dot_r2=False form (its default F mode forms r2 by the
// dot identity |xi'|^2 - 2 xi'.xj' + |xj'|^2 in f32, whose cancellation
// makes DHFR NPT go non-finite; ROADMAP R6). Then the pair function of
// pair_math.cuh with G = dU/dr / r, and the gradient by contraction:
//   row     dU/dx_i = xi' sum_j G - sum_j G xj'
//   column  dU/dx_j = xj' sum_i G - sum_i G xi'    (triangular lists only).
// Triangular lists leave out each row chunk's covering column chunk; it is
// swept first, with the gate row atom < column atom, and each pair's energy
// goes to its row atom. Symmetric lists halve the energy. Output per atom:
// [u_i, dU/dx_i].
//
// What bounds it on the card: arithmetic. At solvated DHFR (744 row chunks)
// the triangular lists at cutoff + skin hold about 21,500 tiles, with the
// covering tiles about 91M pair slots per sweep, each one rsqrt and about 50
// FP32 instructions. The TPU kernel put the two contractions (and in its
// default F mode the cross term) on its matrix unit and carried the column
// reactions across its sequential grid in one VMEM array; a card runs its
// blocks in parallel and in no order, so nothing carries.
//
// What the design does about it:
// * one block of 4 warps per row chunk; lane l holds row atom l, mapped to
//   the center's image once; warp w takes 32 of each tile's 128 column
//   atoms. The tile's column atoms are staged in shared memory by the
//   block's 128 threads, one each, already at the center's image, so the
//   pair loop reads only broadcasts and needs no minimum image;
// * row sums (sum G, sum G xj') stay in registers and the 4 warps' partials
//   are added in a fixed order before the force is assembled once;
// * triangular: each tile's G goes to a 32 x 129 shared array (padded so
//   rows are written and columns read without bank conflicts); after a
//   barrier thread t sums column t over the 32 rows in order, assembles that
//   atom's reaction (force-sized; the raw sums can be 10x larger) and adds it
//   in fixed_point.cuh's int64 fixed point by order-free integer atomics. A
//   second kernel adds the columns to the rows. Two launches are bitwise
//   equal, with no float atomics;
// * padding (q = eps = 0) is swept like any other atom and adds exact
//   zeros, the covering chunk of a padding row chunk included; the lists
//   are swept whole, as in the TPU kernel (no per-step chop).
// Tensor-core forms of the contractions are left to measured later work.

#include <cuda_runtime.h>

#include "fixed_point.cuh"
#include "pair_math.cuh"
#include "row_images.cuh"

using namespace pair_math;
using row_images::col_image;
using row_images::row_image;

namespace {

constexpr int ROW = 32;   // atoms per row chunk
constexpr int COL = 128;  // atoms per column chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // = COL: thread t stages and reduces column atom t
constexpr int COLS_PER_WARP = COL / WARPS;
constexpr int GSTRIDE = COL + 1;  // row stride of the shared G tile

template <int MODE, bool TRI>
__global__ void __launch_bounds__(THREADS) dotscan_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const int* __restrict__ rcen_q,        // (n_rows, 4) row centers in units of CEN_SCALE
    const float* __restrict__ scal,        // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,              // (Npad) row parts [u, dU/dx, dU/dy, dU/dz]
    unsigned long long* __restrict__ acc,  // (3, Npad) fixed-point column parts, zeroed (TRI)
    int n_rows, const Series s) {
  __shared__ float4 cpos[COL];   // the tile's column atoms at the center's image [x' y' z' w]
  __shared__ float4 cpar[COL];   // [q sigma/2 2sqrt(eps) 0]
  __shared__ float4 rpos[ROW];  // the row atoms at the center's image (column pass)
  __shared__ float gt[TRI ? ROW * GSTRIDE : 1];  // the tile's G, row-major
  __shared__ float4 part[WARPS][ROW];
  __shared__ float upart[WARPS][ROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;
  const int n_cols = n_rows * ROW / COL;

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float cut2 = cutoff * cutoff;

  const float3 cen = row_images::center(rcen_q, row);
  const float cx = cen.x, cy = cen.y, cz = cen.z;
  const float cxb = __fmul_rn(cx, ibx), cyb = __fmul_rn(cy, iby), czb = __fmul_rn(cz, ibz);

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0
  const float xl = row_image(ra.x, cx, bx, ibx);
  const float yl = row_image(ra.y, cy, by, iby);
  const float zl = row_image(ra.z, cz, bz, ibz);
  const float wl = ra.w;
  if (TRI && warp == 0) rpos[lane] = make_float4(xl, yl, zl, wl);

  float sg = 0.0f, sgx = 0.0f, sgy = 0.0f, sgz = 0.0f, u = 0.0f;
  const int start = row_start[row];
  const int count = row_count[row];
  for (int k = TRI ? -1 : 0; k < count; ++k) {
    // k = -1: the covering chunk (clamped for padding row chunks past the real ones)
    const int cid = k < 0 ? min(row * ROW / COL, n_cols - 1) : col_ids[start + k];
    __syncthreads();  // every thread is done with the previous tile's shared arrays
    {
      const int j = cid * COL + threadIdx.x;
      const float4 ca = atoms[2 * j];
      const float4 cb = atoms[2 * j + 1];
      const float px = col_image(ca.x, cx, cxb, bx, ibx);
      const float py = col_image(ca.y, cy, cyb, by, iby);
      const float pz = col_image(ca.z, cz, czb, bz, ibz);
      cpos[threadIdx.x] = make_float4(px, py, pz, ca.w);
      cpar[threadIdx.x] = make_float4(cb.x, cb.y, cb.z, 0.0f);
    }
    __syncthreads();
    const int col_gid = cid * COL + warp * COLS_PER_WARP;
#pragma unroll 4
    for (int jj = 0; jj < COLS_PER_WARP; ++jj) {
      const int j = warp * COLS_PER_WARP + jj;
      const float4 cp = cpos[j];
      const float4 cq = cpar[j];
      float g, e;
      pair_terms<MODE>(xl - cp.x, yl - cp.y, zl - cp.z, wl - cp.w, rb.x * cq.x, rb.y + cq.y, rb.z * cq.z, cut2,
                       !TRI || i < col_gid + jj, s, g, e);
      sg += g;
      sgx = fmaf(g, cp.x, sgx);
      sgy = fmaf(g, cp.y, sgy);
      sgz = fmaf(g, cp.z, sgz);
      if (MODE == FORCE_ENERGY) u += e;
      if (TRI) gt[lane * GSTRIDE + j] = g;
    }
    if (TRI) {
      __syncthreads();
      const int t = threadIdx.x;
      float cg = 0.0f, cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;
#pragma unroll 8
      for (int r = 0; r < ROW; ++r) {
        const float g = gt[r * GSTRIDE + t];
        const float4 rp = rpos[r];
        cg += g;
        cgx = fmaf(g, rp.x, cgx);
        cgy = fmaf(g, rp.y, cgy);
        cgz = fmaf(g, rp.z, cgz);
      }
      const float4 p = cpos[t];
      const float fx = p.x * cg - cgx;  // this tile's part of dU/dx of column atom t
      const float fy = p.y * cg - cgy;
      const float fz = p.z * cg - cgz;
      if (fx != 0.0f || fy != 0.0f || fz != 0.0f) {
        const int n_pad = n_rows * ROW;
        const int j = cid * COL + t;
        fixed_point::add(acc + j, fx);
        fixed_point::add(acc + n_pad + j, fy);
        fixed_point::add(acc + 2 * n_pad + j, fz);
      }
    }
  }

  part[warp][lane] = make_float4(sg, sgx, sgy, sgz);
  upart[warp][lane] = u;
  __syncthreads();
  if (warp == 0) {
    float4 a = part[0][lane];
    float uu = upart[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = part[w][lane];
      a.x += p.x;
      a.y += p.y;
      a.z += p.z;
      a.w += p.w;
      uu += upart[w][lane];
    }
    out[i] = make_float4(TRI ? uu : 0.5f * uu, xl * a.x - a.y, yl * a.x - a.z, zl * a.x - a.w);
  }
}

template <int MODE, bool TRI>
void launch(const float4* a, const int* rs, const int* rc, const int* ci, const int* cq, const float* sc, float4* o,
            unsigned long long* ac, int n_rows, const Series& s, cudaStream_t st) {
  dotscan_kernel<MODE, TRI><<<n_rows, THREADS, 0, st>>>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s);
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`, then (triangular) the
// column pass. Device pointers: atoms (Npad, 8) f32, row_start/row_count
// (n_rows,) i32, col_ids i32, rcen_q (n_rows * 4,) i32, scal (4,) f32, out
// (Npad, 4) f32, acc (3, Npad) i64 set to zero (triangular only). h and p are
// host arrays of 11 floats. mode: 0 forces, 1 forces + energy; triangular:
// 0 symmetric lists, 1 Newton-triangular. Returns cudaGetLastError().
extern "C" int dotscan_sweep_launch(const void* atoms, const void* row_start, const void* row_count,
                                    const void* col_ids, const void* rcen_q, const void* scal, void* out, void* acc,
                                    int n_rows, int mode, int triangular, const float* h, const float* p,
                                    void* stream) {
  const Series s = make_series(h, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* ci = static_cast<const int*>(col_ids);
  const int* cq = static_cast<const int*>(rcen_q);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  if (mode == FORCE && triangular) {
    launch<FORCE, true>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
  } else if (mode == FORCE) {
    launch<FORCE, false>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
  } else if (mode == FORCE_ENERGY && triangular) {
    launch<FORCE_ENERGY, true>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
  } else if (mode == FORCE_ENERGY) {
    launch<FORCE_ENERGY, false>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !triangular) return static_cast<int>(err);
  fixed_point::launch_add_columns(o, acc, n_rows * ROW, st);
  return static_cast<int>(cudaGetLastError());
}
