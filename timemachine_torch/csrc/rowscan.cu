// Rowscan pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rowscan_kernel` / `_rowscan_row_chunk` of
// timemachine_tpu/ops/pallas/rowscan_kernel.py in the forms a configuration
// launches, 10 of the 24 that its options make: three modes (forces every
// MD step; forces + energy for FIRE and the stateless energy/force; energy
// only for the barostat's trial energies, JAX's `u_only`), symmetric or
// Newton-triangular lists, per-pair minimum image or row-center images
// ("preshift", `rcen_q`), with or without the 4D w lift (the launcher lists
// the 10; it refuses the rest). Plain PyTorch version, in every form:
// rowscan_sweep_plain in timemachine_torch/ops/rowscan_kernel.py.
//
// What it computes, per row atom i: the sum over listed column atoms j with
// (r2 < cutoff^2) & (r2 > 1e-7) of pair_math.cuh's pair function (LJ +
// polynomial electrostatics) and of its gradient (dU/dr / r) (x_i - x_j).
// Atom rows are [x y z w q sigma/2 2 sqrt(eps) 0]; padding atoms carry
// q = eps = 0. Symmetric lists visit every pair from both atoms and halve
// the energy. Triangular lists leave out each row chunk's covering column
// chunk (row * 32 / 128); it is swept first with the gate row atom <
// column atom, each pair's energy goes to its row atom, and its force to
// both atoms (none to the column in energy-only mode). Preshift maps each
// row atom once, and each column atom once per tile, to its image nearest
// the row chunk's periodic center (row_images.cuh), so the pair loop has no
// rounding. Without w, r2 has no dw term. Output per atom: [u_i, dU/dx_i].
//
// What bounds it on the card: FP32 issue. At solvated DHFR (744 row chunks)
// the main path's form (triangular, preshift, no w) sweeps about 79M pair
// slots per step, each one rsqrt and about 60 FP32 instructions (two 11-term
// Horner chains dominate), against 64 KB of atom rows read per step. The
// symmetric form sweeps twice the slots and pays 9 instructions per slot
// for the minimum image and 2 for w; with one block per row chunk the
// longest lists set its tail. No tensor cores: the pair function has no matrix
// product, and the dot identity that would make one is too coarse for
// DHFR's bonded neighbours in f32 (ROADMAP R6), and coarser in TF32.
//
// What the triangular design does about it:
// * work items of (row chunk, list segment): the row's list, covering chunk
//   first, is cut into SPLITS near-equal segments (grid n_rows x SPLITS),
//   so no item is longer than an eighth of the longest list and the
//   scheduler balances the SMs (the main form's F sweep at DHFR on one
//   H100: 0.248 ms with 1 segment, 0.187 with 8, 0.187 with 16; PERF.md).
//   Every item adds its row sums and its column
//   reactions into one int64 fixed-point accumulator (fixed_point.cuh) by
//   integer atomics, which are order-free: two launches are bitwise equal.
//   A sum past the accumulator's range (a near-overlap in a barostat
//   trial) turns the whole result into NaN, never a wrapped finite sum. A
//   last pass converts the sums to f32;
// * each thread holds two row atoms (l and l + 16) against 16 columns of a
//   128-column tile, so every column read from shared memory serves two
//   pairs, and the two pairs give each Horner chain an independent twin;
// * column chunks arrive by cp.async in a ring of 3 shared-memory stages,
//   one tile ahead; each thread copies, and in preshift images in place,
//   its own column atom;
// * the column reactions are reduced once per tile: each pair's G =
//   dU/dr / r goes to a 32 x 129 shared tile (padded: rows are written and
//   columns read without bank conflicts), and thread t sums column t in a
//   fixed order. With preshift the reaction is the contraction
//   xj' sum_i G - sum_i G xi' (one float per pair); with per-pair images
//   the three products G dx are stored instead. One int64 atomic per column
//   atom, axis and tile, never a float atomic;
// * energy-only sweeps keep one barrier per tile and no reactions.
// The symmetric form keeps the first design (one block of 4 warps per row
// chunk, lane = row atom, warp = 32 columns, register prefetch, fixed-order
// warp sums) and is the yardstick the triangular form is timed against.
// `e4 * t6` is formed before any t6^2, so a zero eps zeroes what would
// otherwise be 0 * inf: build without --use_fast_math. The series
// coefficients are kernel parameters (constant bank); box and cutoff are
// read from a 4-float device array, so the host never syncs.

#include <cuda_runtime.h>

#include "cp_async.cuh"
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
constexpr int THREADS = WARPS * 32;  // = COL: a triangular block's thread t stages and reduces column atom t
constexpr int COLS_PER_WARP = COL / WARPS;
constexpr int GROUPS = 8;                // triangular: column groups of a tile, two per warp
constexpr int COLS_PER_GROUP = COL / GROUPS;
constexpr int STAGES = 3;                // triangular: cp.async ring of column tiles
constexpr int SPLITS = 8;                // triangular: list segments per row chunk, each a block
constexpr int GSTRIDE = COL + 1;         // row stride of the shared G tile

struct Frame {
  float bx, by, bz, ibx, iby, ibz, cut2;
  float cx, cy, cz, cxb, cyb, czb;  // row center and center / box (preshift)
};

__device__ __forceinline__ Frame make_frame(const float* scal, const int* rcen_q, int row, bool pre) {
  Frame f;
  f.bx = scal[0];
  f.by = scal[1];
  f.bz = scal[2];
  f.ibx = 1.0f / f.bx;
  f.iby = 1.0f / f.by;
  f.ibz = 1.0f / f.bz;
  f.cut2 = scal[3] * scal[3];
  const float3 c = pre ? row_images::center(rcen_q, row) : make_float3(0.f, 0.f, 0.f);
  f.cx = c.x;
  f.cy = c.y;
  f.cz = c.z;
  f.cxb = __fmul_rn(c.x, f.ibx);
  f.cyb = __fmul_rn(c.y, f.iby);
  f.czb = __fmul_rn(c.z, f.ibz);
  return f;
}

__device__ __forceinline__ float4 row_at_center(float4 p, const Frame& f) {
  return make_float4(row_image(p.x, f.cx, f.bx, f.ibx), row_image(p.y, f.cy, f.by, f.iby),
                     row_image(p.z, f.cz, f.bz, f.ibz), p.w);
}

__device__ __forceinline__ float4 col_at_center(float4 p, const Frame& f) {
  return make_float4(col_image(p.x, f.cx, f.cxb, f.bx, f.ibx), col_image(p.y, f.cy, f.cyb, f.by, f.iby),
                     col_image(p.z, f.cz, f.czb, f.bz, f.ibz), p.w);
}

// One pair: row atom (rp position, rq parameters) against column atom (cp,
// cq). Returns the differences d and (G = dU/dr / r, energy) as pair_terms.
template <int MODE, bool PRE, bool W>
__device__ __forceinline__ void pair(const float4& rp, const float4& rq, const float4& cp, const float4& cq,
                                     const Frame& f, bool listed, const Series& s, float& dx, float& dy, float& dz,
                                     float& g, float& e) {
  dx = rp.x - cp.x;
  dy = rp.y - cp.y;
  dz = rp.z - cp.z;
  if (!PRE) {
    dx -= f.bx * rintf(dx * f.ibx);
    dy -= f.by * rintf(dy * f.iby);
    dz -= f.bz * rintf(dz * f.ibz);
  }
  float r2;
  if (W) {
    const float dw = rp.w - cp.w;
    r2 = dx * dx + dy * dy + dz * dz + dw * dw;
  } else {
    r2 = dx * dx + dy * dy + dz * dz;
  }
  pair_terms_r2<MODE>(r2, rq.x * cq.x, rq.y + cq.y, rq.z * cq.z, f.cut2, listed, s, g, e);
}

// -- symmetric lists ------------------------------------------------------------

// F mode with per-pair minimum image and w, the one symmetric form built
// (phase 3's yardstick); the plain version keeps the others
__global__ void __launch_bounds__(THREADS) sym_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const float* __restrict__ scal,  // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,        // (Npad) [0, dU/dx, dU/dy, dU/dz]
    const Series s) {
  __shared__ float4 tile[2 * COL];
  __shared__ float4 part[WARPS][ROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;
  const Frame f = make_frame(scal, nullptr, row, false);

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int start = row_start[row];
  const int count = row_count[row];

  // thread t stages float4 t and t + THREADS of the chunk
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
      float dx, dy, dz, de_r, e;
      pair<FORCE, false, true>(ra, rb, tile[2 * j], tile[2 * j + 1], f, true, s, dx, dy, dz, de_r, e);
      gx = fmaf(de_r, dx, gx);
      gy = fmaf(de_r, dy, gy);
      gz = fmaf(de_r, dz, gz);
    }
  }

  part[warp][lane] = make_float4(0.0f, gx, gy, gz);
  __syncthreads();
  if (warp == 0) {
    float4 acc = part[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = part[w][lane];
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    out[i] = acc;
  }
}

// -- Newton-triangular lists ------------------------------------------------------

// shared floats of the G tile: none in energy-only mode, G per pair with
// preshift (contraction), G dx, G dy, G dz per pair with per-pair images
template <int MODE, bool PRE>
constexpr int g_floats() {
  return MODE == ENERGY ? 0 : (PRE ? 1 : 3) * ROW * GSTRIDE;
}

template <int MODE, bool PRE>
constexpr int tri_smem_bytes() {
  return (STAGES * 2 * COL + ROW + GROUPS * ROW) * 16 + g_floats<MODE, PRE>() * 4;
}

// The row atoms (a = l16, b = l16 + 16) of one thread against its 16
// columns of a staged tile; DIAG gates the covering tile by sorted index.
template <int MODE, bool PRE, bool W, bool DIAG>
__device__ __forceinline__ void tri_tile(const float4* __restrict__ tile, float* __restrict__ gt, int grp, int l16,
                                         int ia, int col0, const float4& pa, const float4& qa, const float4& pb,
                                         const float4& qb, const Frame& f, const Series& s, float4& acc_a,
                                         float4& acc_b) {
#pragma unroll 2
  for (int jj = 0; jj < COLS_PER_GROUP; ++jj) {
    const int j = grp * COLS_PER_GROUP + jj;
    const float4 cp = tile[2 * j];
    const float4 cq = tile[2 * j + 1];
    float dxa, dya, dza, ga, ea, dxb, dyb, dzb, gb, eb;
    pair<MODE, PRE, W>(pa, qa, cp, cq, f, !DIAG || ia < col0 + j, s, dxa, dya, dza, ga, ea);
    pair<MODE, PRE, W>(pb, qb, cp, cq, f, !DIAG || ia + 16 < col0 + j, s, dxb, dyb, dzb, gb, eb);
    if (MODE != ENERGY) {
      acc_a.y = fmaf(ga, dxa, acc_a.y);
      acc_a.z = fmaf(ga, dya, acc_a.z);
      acc_a.w = fmaf(ga, dza, acc_a.w);
      acc_b.y = fmaf(gb, dxb, acc_b.y);
      acc_b.z = fmaf(gb, dyb, acc_b.z);
      acc_b.w = fmaf(gb, dzb, acc_b.w);
      const int oa = l16 * GSTRIDE + j, ob = (l16 + 16) * GSTRIDE + j;
      if (PRE) {
        gt[oa] = ga;
        gt[ob] = gb;
      } else {
        constexpr int plane = ROW * GSTRIDE;
        gt[oa] = ga * dxa;
        gt[plane + oa] = ga * dya;
        gt[2 * plane + oa] = ga * dza;
        gt[ob] = gb * dxb;
        gt[plane + ob] = gb * dyb;
        gt[2 * plane + ob] = gb * dzb;
      }
    }
    if (MODE != FORCE) {
      acc_a.x += ea;
      acc_b.x += eb;
    }
  }
}

template <int MODE, bool PRE, bool W>
__global__ void __launch_bounds__(THREADS) tri_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const int* __restrict__ rcen_q,        // (n_rows, 4) row centers (preshift)
    const float* __restrict__ scal,        // [box_x, box_y, box_z, cutoff]
    unsigned long long* __restrict__ acc,  // (4 Npad + 1) fixed-point [u, dU/dx, dU/dy, dU/dz], then the flag; zeroed
    int n_rows, const Series s) {
  extern __shared__ float4 smem[];
  float4* stages = smem;                     // [STAGES][2 * COL] column atoms, as in atoms
  float4* rpos = stages + STAGES * 2 * COL;  // [ROW] the row atoms at the center's image (preshift)
  float4* part = rpos + ROW;                 // [GROUPS][ROW] row sums [u, dU/dx]
  float* gt = reinterpret_cast<float*>(part + GROUPS * ROW);

  const int row = blockIdx.x;
  // this block's segment [k0, k1) of the row's list, the covering chunk at 0
  const int len = row_count[row] + 1;
  const int k0 = len * blockIdx.y / gridDim.y;
  const int k1 = len * (blockIdx.y + 1) / gridDim.y;
  if (k0 == k1) return;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int l16 = lane & 15;
  const int grp = 2 * warp + (lane >> 4);
  const int n_pad = n_rows * ROW;
  unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
  const int start = row_start[row];
  const int cover = min(row * ROW / COL, n_pad / COL - 1);  // clamped for padding row chunks
  const Frame f = make_frame(scal, rcen_q, row, PRE);

  const int ia = row * ROW + l16;
  float4 pa = atoms[2 * ia];
  const float4 qa = atoms[2 * ia + 1];
  float4 pb = atoms[2 * (ia + 16)];
  const float4 qb = atoms[2 * (ia + 16) + 1];
  if (PRE) {
    pa = row_at_center(pa, f);
    pb = row_at_center(pb, f);
    if (grp == 0) {
      rpos[l16] = pa;
      rpos[l16 + 16] = pb;
    }
  }

  auto chunk = [&](int k) { return k == 0 ? cover : col_ids[start + k - 1]; };
  auto issue = [&](int k) {  // thread t copies column atom t of tile k into its stage
    const float4* src = atoms + (static_cast<size_t>(chunk(k)) * COL + t) * 2;
    float4* dst = stages + (k % STAGES) * (2 * COL) + 2 * t;
    cp_async16(dst, src);
    cp_async16(dst + 1, src + 1);
    cp_async_commit();
  };

  float4 acc_a = make_float4(0.f, 0.f, 0.f, 0.f), acc_b = acc_a;
  issue(k0);
  for (int k = k0; k < k1; ++k) {
    if (k + 1 < k1) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float4* tile = stages + (k % STAGES) * (2 * COL);
    if (PRE) tile[2 * t] = col_at_center(tile[2 * t], f);
    // every column atom of tile k is staged; every thread is done with the
    // previous tile's G and with the stage the next copy overwrites
    __syncthreads();
    const int cid = chunk(k);
    if (k == 0) {
      tri_tile<MODE, PRE, W, true>(tile, gt, grp, l16, ia, cid * COL, pa, qa, pb, qb, f, s, acc_a, acc_b);
    } else {
      tri_tile<MODE, PRE, W, false>(tile, gt, grp, l16, ia, cid * COL, pa, qa, pb, qb, f, s, acc_a, acc_b);
    }
    if (MODE != ENERGY) {
      __syncthreads();  // the tile's G is complete
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;  // dU/dx of column atom t from this tile
      if (PRE) {
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
        const float4 p = tile[2 * t];
        rx = p.x * cg - cgx;
        ry = p.y * cg - cgy;
        rz = p.z * cg - cgz;
      } else {
        constexpr int plane = ROW * GSTRIDE;
#pragma unroll 8
        for (int r = 0; r < ROW; ++r) {
          rx -= gt[r * GSTRIDE + t];
          ry -= gt[plane + r * GSTRIDE + t];
          rz -= gt[2 * plane + r * GSTRIDE + t];
        }
      }
      const int j = cid * COL + t;
      fixed_point::add_checked(acc + n_pad + j, rx, flag);
      fixed_point::add_checked(acc + 2 * n_pad + j, ry, flag);
      fixed_point::add_checked(acc + 3 * n_pad + j, rz, flag);
    }
  }

  part[grp * ROW + l16] = acc_a;
  part[grp * ROW + l16 + 16] = acc_b;
  __syncthreads();
  if (t < ROW) {
    float4 a = part[t];
#pragma unroll
    for (int g = 1; g < GROUPS; ++g) {
      const float4 p = part[g * ROW + t];
      a.x += p.x;
      a.y += p.y;
      a.z += p.z;
      a.w += p.w;
    }
    const int i = row * ROW + t;
    if (MODE != FORCE) fixed_point::add_checked(acc + i, a.x, flag);
    if (MODE != ENERGY) {
      fixed_point::add_checked(acc + n_pad + i, a.y, flag);
      fixed_point::add_checked(acc + 2 * n_pad + i, a.z, flag);
      fixed_point::add_checked(acc + 3 * n_pad + i, a.w, flag);
    }
  }
}

struct Launch {
  const float4* atoms;
  const int *row_start, *row_count, *col_ids, *rcen_q;
  const float* scal;
  float4* out;
  unsigned long long* acc;
  int n_rows;
  Series s;
  cudaStream_t stream;
};

int launch_sym(const Launch& a) {
  sym_kernel<<<a.n_rows, THREADS, 0, a.stream>>>(a.atoms, a.row_start, a.row_count, a.col_ids, a.scal, a.out, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool PRE, bool W>
int launch_tri(const Launch& a) {
  constexpr int bytes = tri_smem_bytes<MODE, PRE>();
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(tri_kernel<MODE, PRE, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tri_kernel<MODE, PRE, W><<<dim3(a.n_rows, SPLITS), THREADS, bytes, a.stream>>>(
      a.atoms, a.row_start, a.row_count, a.col_ids, a.rcen_q, a.scal, a.acc, a.n_rows, a.s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_store_checked(a.out, a.acc, a.n_rows * ROW, a.stream);
  return static_cast<int>(cudaGetLastError());
}

// The triangular forms F and U at either images, with or without w (the MD
// provider's sweep and barostat energy)
template <int MODE>
int launch_images(const Launch& a, bool pre, bool w) {
  if (pre) return w ? launch_tri<MODE, true, true>(a) : launch_tri<MODE, true, false>(a);
  return w ? launch_tri<MODE, false, true>(a) : launch_tri<MODE, false, false>(a);
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_rows,) i32, col_ids i32,
// rcen_q (n_rows * 4,) i32 (read with preshift only), scal (4,) f32, out
// (Npad, 4) f32, acc (4 Npad + 1,) i64 set to zero (triangular only). h
// and p are host arrays of 11 floats. mode: 0 forces, 1 forces + energy, 2
// energy; triangular, preshift, has_w: 0 or 1. A form that is not built
// returns cudaErrorInvalidValue and launches nothing; else the first CUDA
// error, or 0.
extern "C" int rowscan_sweep_launch(const void* atoms, const void* row_start, const void* row_count,
                                    const void* col_ids, const void* rcen_q, const void* scal, void* out, void* acc,
                                    int n_rows, int mode, int triangular, int preshift, int has_w, const float* h,
                                    const float* p, void* stream) {
  const Launch a{static_cast<const float4*>(atoms),
                 static_cast<const int*>(row_start),
                 static_cast<const int*>(row_count),
                 static_cast<const int*>(col_ids),
                 static_cast<const int*>(rcen_q),
                 static_cast<const float*>(scal),
                 static_cast<float4*>(out),
                 static_cast<unsigned long long*>(acc),
                 n_rows,
                 make_series(h, p),
                 static_cast<cudaStream_t>(stream)};
  // the 10 forms a configuration reaches: triangular F and U in every form
  // (the MD providers), triangular F+U with minimum image and w (the
  // energy/force entry), symmetric F with minimum image and w (the yardstick)
  if (triangular) {
    if (mode == FORCE) return launch_images<FORCE>(a, preshift, has_w);
    if (mode == ENERGY) return launch_images<ENERGY>(a, preshift, has_w);
    if (mode == FORCE_ENERGY && !preshift && has_w) return launch_tri<FORCE_ENERGY, false, true>(a);
  } else if (mode == FORCE && !preshift && has_w) {
    return launch_sym(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
