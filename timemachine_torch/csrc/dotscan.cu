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
// What bounds it on the card: FP32 issue. At solvated DHFR (744 row chunks)
// the triangular lists at cutoff + skin hold about 21,500 tiles, with the
// covering tiles about 91M pair slots per sweep for 8.3M pairs within the
// cutoff, each slot one rsqrt and about 50 FP32 instructions. The TPU
// kernel put the two contractions (and in its default F mode the cross
// term) on its matrix unit and carried the column reactions across its
// sequential grid in one VMEM array; a card runs its blocks in parallel and
// in no order, so nothing carries. The first triangular design swept every
// slot, with three barriers, a shared-memory store of G per slot and a
// second shared-memory pass per tile, in one block per row chunk whose
// longest lists set the tail.
//
// What the triangular design does about it:
// * a per-step cull at the bare cutoff + CULL_SLACK: each column atom, at the
//   row center's image, is tested against the box of the row chunk's atoms at
//   their images. Those are the positions the pair function subtracts, the
//   gap bounds each pair's distance from below and w only adds to r2, so the
//   cull drops no pair within the cutoff;
// * warp w takes the 32 columns [32 w, 32 w + 32) of every tile of its
//   block's list segment; its live columns are compacted, by ballot and
//   prefix in tile and lane order (deterministic), into a ring of 64
//   shared-memory slots (live_columns.cuh), each with its center image,
//   parameters, sorted index and covering-tile gate, and swept in chunks of
//   32. Each lane holds two row atoms (l % 16 and l % 16 + 16), and half-warp
//   h takes the chunk's slots 16 h .. 16 h + 15: lane l pairs both its rows
//   with slot 16 h + (l + k) % 16 at step k, reading the column from shared
//   memory once for two pairs, and carries that slot's four column sums (sum
//   G, sum G xi'), handed on within the half-warp by four shuffles a step;
//   after 16 steps lane l contracts slot l's reaction. No barrier: every warp
//   works alone, and each lane copies, and later reads, its own column atom;
// * work items of (row chunk, list segment): each row's list, covering chunk
//   first, is cut into SPLITS near-equal segments, one block of WARPS warps
//   each (of 1, 2, 4 and 8 segments, 4 ran fastest at DHFR on an H100); the
//   column atoms arrive by cp.async in a ring of STAGES stages per
//   warp, STAGES - 1 tiles ahead (the warp reads the column chunk ids of 32
//   tiles at once, one per lane);
// * row sums (the contraction, formed per warp) and column reactions go into
//   one int64 fixed-point accumulator (fixed_point.cuh) by integer atomics,
//   which are order-free: two launches are bitwise equal. A sum past the
//   accumulator's range (a near-overlap in a barostat trial) turns the whole
//   result into NaN, never a wrapped finite sum. A last pass converts the
//   sums to f32;
// * padding (q = eps = 0) is culled and swept like any other atom and adds
//   exact zeros, the covering chunk of a padding row chunk included.
// FP32 on the CUDA cores: a tensor-core cross term would bring back the dot
// identity (R6), and TF32 is coarser still for force-sized contractions
// whose raw sums are 10x the result.
// The symmetric form keeps the first design (one block of 4 warps per row
// chunk, lane = row atom, warp = 32 of each tile's columns, staged at the
// center's image) and is the yardstick the triangular form is timed against.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fixed_point.cuh"
#include "live_columns.cuh"
#include "pair_math.cuh"
#include "row_images.cuh"

using namespace live_columns;
using namespace pair_math;
using row_images::col_image;
using row_images::row_image;

namespace {

constexpr int ROW = 32;   // atoms per row chunk
constexpr int COL = 128;  // atoms per column chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // = COL
constexpr int COLS_PER_WARP = COL / WARPS;
constexpr int SPLITS = 4;  // list segments per row chunk, triangular form (dotscan_kernel.SPLITS mirrors it)

// -- symmetric lists: the first design -----------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(THREADS) sym_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const int* __restrict__ rcen_q,        // (n_rows, 4) row centers in units of CEN_SCALE
    const float* __restrict__ scal,        // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,              // (Npad) [u, dU/dx, dU/dy, dU/dz]
    const Series s) {
  __shared__ float4 cpos[COL];   // the tile's column atoms at the center's image [x' y' z' w]
  __shared__ float4 cpar[COL];   // [q sigma/2 2sqrt(eps) 0]
  __shared__ float4 part[WARPS][ROW];
  __shared__ float upart[WARPS][ROW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;

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

  float sg = 0.0f, sgx = 0.0f, sgy = 0.0f, sgz = 0.0f, u = 0.0f;
  const int start = row_start[row];
  const int count = row_count[row];
  for (int k = 0; k < count; ++k) {
    const int cid = col_ids[start + k];
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
#pragma unroll 4
    for (int jj = 0; jj < COLS_PER_WARP; ++jj) {
      const int j = warp * COLS_PER_WARP + jj;
      const float4 cp = cpos[j];
      const float4 cq = cpar[j];
      float g, e;
      pair_terms<MODE>(xl - cp.x, yl - cp.y, zl - cp.z, wl - cp.w, rb.x * cq.x, rb.y + cq.y, rb.z * cq.z, cut2, true,
                       s, g, e);
      sg += g;
      sgx = fmaf(g, cp.x, sgx);
      sgy = fmaf(g, cp.y, sgy);
      sgz = fmaf(g, cp.z, sgz);
      if (MODE == FORCE_ENERGY) u += e;
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
    out[i] = make_float4(0.5f * uu, xl * a.x - a.y, yl * a.x - a.z, zl * a.x - a.w);
  }
}

// -- Newton-triangular lists: the redesign --------------------------------------------

// A row atom of a lane: position at the center's image [x' y' z' w],
// parameters [q sigma/2 2sqrt(eps) 0], sorted index, contraction sums
// (sum G, sum G xj') and energy
struct RowAtom {
  float4 p, q;
  int i;
  float sg, sgx, sgy, sgz, u;
};

// One pair: row atom r against the column atom (cp at the center's image,
// cq; gate index in cq.w), its terms added to r's sums; returns G.
template <int MODE>
__device__ __forceinline__ float pair_into(RowAtom& r, const float4& cp, const float4& cq, float cut2,
                                           const Series& s) {
  float g, e;
  pair_terms<MODE>(r.p.x - cp.x, r.p.y - cp.y, r.p.z - cp.z, r.p.w - cp.w, r.q.x * cq.x, r.q.y + cq.y, r.q.z * cq.z,
                   cut2, r.i < __float_as_int(cq.w), s, g, e);
  r.sg += g;
  r.sgx = fmaf(g, cp.x, r.sgx);
  r.sgy = fmaf(g, cp.y, r.sgy);
  r.sgz = fmaf(g, cp.z, r.sgz);
  if (MODE == FORCE_ENERGY) r.u += e;
  return g;
}

// One chunk of the warp's ring (live_columns.cuh), slots base .. base + 31,
// the first n live: lane l pairs its two row atoms (rows l % 16 and
// l % 16 + 16) with slot_at(base, l, k) at step k and carries that slot's
// four column sums, handed on within the half-warp by four shuffles a
// step; after 16 steps lane l contracts slot l's reaction and adds it in
// fixed point (checked: the flag follows the four planes of acc).
template <int MODE>
__device__ __forceinline__ void sweep_chunk(const WarpSmem& sm, int base, int n, int lane, RowAtom& a, RowAtom& b,
                                            float cut2, const Series& s, unsigned long long* __restrict__ acc,
                                            int n_pad) {
  const int from = next_lane(lane);
  float cg = 0.0f, cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;  // the column sums of slot_at(base, lane, k) at step k
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const int slot = slot_at(base, lane, k);
    const float4 cp = sm.pos[slot];
    const float4 cq = sm.par[slot];
    const float ga = pair_into<MODE>(a, cp, cq, cut2, s);
    const float gb = pair_into<MODE>(b, cp, cq, cut2, s);
    cg += ga;
    cgx = fmaf(ga, a.p.x, cgx);
    cgy = fmaf(ga, a.p.y, cgy);
    cgz = fmaf(ga, a.p.z, cgz);
    cg += gb;
    cgx = fmaf(gb, b.p.x, cgx);
    cgy = fmaf(gb, b.p.y, cgy);
    cgz = fmaf(gb, b.p.z, cgz);
    // hand the column sums on: lane l now carries slot_at(base, l, k + 1)
    cg = __shfl_sync(FULL, cg, from);
    cgx = __shfl_sync(FULL, cgx, from);
    cgy = __shfl_sync(FULL, cgy, from);
    cgz = __shfl_sync(FULL, cgz, from);
  }
  if (lane < n) {
    unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
    const int slot = (base + lane) & (RING - 1);
    const float4 q = sm.pos[slot];
    const int j = sm.idx[slot];
    // this chunk's part of dU/dx of the column atom
    fixed_point::add_checked(acc + n_pad + j, q.x * cg - cgx, flag);
    fixed_point::add_checked(acc + 2 * n_pad + j, q.y * cg - cgy, flag);
    fixed_point::add_checked(acc + 3 * n_pad + j, q.z * cg - cgz, flag);
  }
}

// r's sums += their values in the other half-warp (the same row atom's other columns)
__device__ __forceinline__ void add_halves(RowAtom& r) {
  r.sg += __shfl_xor_sync(FULL, r.sg, 16);
  r.sgx += __shfl_xor_sync(FULL, r.sgx, 16);
  r.sgy += __shfl_xor_sync(FULL, r.sgy, 16);
  r.sgz += __shfl_xor_sync(FULL, r.sgz, 16);
  r.u += __shfl_xor_sync(FULL, r.u, 16);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) tri_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const int* __restrict__ rcen_q,        // (n_rows, 4) row centers in units of CEN_SCALE
    const float* __restrict__ scal,        // [box_x, box_y, box_z, cutoff]
    unsigned long long* __restrict__ acc,  // (4 Npad + 1) fixed-point [u, dU/dx, dU/dy, dU/dz], then the flag; zeroed
    int n_rows, const Series s) {
  __shared__ WarpSmem smem[WARPS];
  const int row = blockIdx.x;
  // this block's segment [k0, k1) of the row's list, the covering chunk at 0
  const int len = row_count[row] + 1;
  const int k0 = len * blockIdx.y / SPLITS;
  const int k1 = len * (blockIdx.y + 1) / SPLITS;
  if (k0 == k1) return;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpSmem& sm = smem[warp];
  const int n_pad = n_rows * ROW;
  const int start = row_start[row];
  const int cover = min(row * ROW / COL, n_pad / COL - 1);  // clamped for padding row chunks

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float cut2 = cutoff * cutoff;
  const float cull = cutoff + CULL_SLACK;
  const float cull2 = cull * cull;
  const float3 cen = row_images::center(rcen_q, row);
  const float cxb = __fmul_rn(cen.x, ibx), cyb = __fmul_rn(cen.y, iby), czb = __fmul_rn(cen.z, ibz);

  // rows l % 16 and l % 16 + 16 at the center's images
  auto row_atom = [&](int i) {
    const float4 r = atoms[2 * i];
    const float4 p = make_float4(row_image(r.x, cen.x, bx, ibx), row_image(r.y, cen.y, by, iby),
                                 row_image(r.z, cen.z, bz, ibz), r.w);
    return RowAtom{p, atoms[2 * i + 1], i, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  };
  const int ia = row * ROW + (lane & 15);
  RowAtom a = row_atom(ia), b = row_atom(ia + 16);
  // the row chunk's box at the center's images (padding atoms included)
  const float lox = warp_min(fminf(a.p.x, b.p.x)), loy = warp_min(fminf(a.p.y, b.p.y));
  const float loz = warp_min(fminf(a.p.z, b.p.z));
  const float hix = warp_max(fmaxf(a.p.x, b.p.x)), hiy = warp_max(fmaxf(a.p.y, b.p.y));
  const float hiz = warp_max(fmaxf(a.p.z, b.p.z));

  int head = 0, tail = 0;  // live columns written / swept (warp-uniform)
  constexpr int AHEAD = STAGES - 1;
  for (int e0 = k0; e0 < k1; e0 += 32) {
    // up to 32 tiles at once: lane l reads the column chunk of tile e0 + l
    const int n_tiles = min(32, k1 - e0);
    const int k_own = e0 + lane;
    const int cid_own = lane < n_tiles ? (k_own == 0 ? cover : col_ids[start + k_own - 1]) : 0;
    int n_issued = 0;
    auto issue = [&]() {  // lane l copies column atom 32 w + l of the next tile into its stage
      const int cid = __shfl_sync(FULL, cid_own, n_issued);
      const float4* src = atoms + 2 * (static_cast<size_t>(cid) * COL + warp * COLS_PER_WARP + lane);
      float4* dst = &sm.stage[n_issued++ & (STAGES - 1)][2 * lane];
      cp_async16(dst, src);
      cp_async16(dst + 1, src + 1);
      cp_async_commit();
    };
    __syncwarp();  // this lane's reads of the stages of the last batch are done
    for (int t = 0; t < AHEAD && n_issued < n_tiles; ++t) issue();
    for (int t = 0; t < n_tiles; ++t) {
      __syncwarp();  // this lane's reads of the stage the next copy overwrites are done
      if (n_issued < n_tiles) {
        issue();
        cp_async_wait<AHEAD>();
      } else {
        cp_async_wait<0>();
      }
      const int st = t & (STAGES - 1);
      const float4 ca = sm.stage[st][2 * lane];
      const float4 cq = sm.stage[st][2 * lane + 1];
      const float px = col_image(ca.x, cen.x, cxb, bx, ibx);
      const float py = col_image(ca.y, cen.y, cyb, by, iby);
      const float pz = col_image(ca.z, cen.z, czb, bz, ibz);
      const float gx = fmaxf(fmaxf(px - hix, lox - px), 0.0f);
      const float gy = fmaxf(fmaxf(py - hiy, loy - py), 0.0f);
      const float gz = fmaxf(fmaxf(pz - hiz, loz - pz), 0.0f);
      const int j = __shfl_sync(FULL, cid_own, t) * COL + warp * COLS_PER_WARP + lane;
      head += push(sm, head, lane, gx * gx + gy * gy + gz * gz < cull2, make_float4(px, py, pz, ca.w), cq,
                   e0 + t == 0 ? j : NO_GATE, j);
      if (head - tail >= ROW) {
        __syncwarp();  // the chunk's slots are written
        sweep_chunk<MODE>(sm, tail, ROW, lane, a, b, cut2, s, acc, n_pad);
        tail += ROW;
        __syncwarp();  // every lane is done with the chunk before its slots are written again
      }
    }
  }
  if (head > tail) {  // the last chunk, padded with dead slots
    fill_dead(sm, tail, head - tail, lane);
    sweep_chunk<MODE>(sm, tail, head - tail, lane, a, b, cut2, s, acc, n_pad);
  }
  // each half-warp swept half of every chunk: add the halves, then lane l
  // adds row l's part (rows l % 16 in the first half-warp, l % 16 + 16 in the second)
  add_halves(a);
  add_halves(b);
  const RowAtom r = lane < 16 ? a : b;
  unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
  if (MODE == FORCE_ENERGY) fixed_point::add_checked(acc + r.i, r.u, flag);
  fixed_point::add_checked(acc + n_pad + r.i, r.p.x * r.sg - r.sgx, flag);
  fixed_point::add_checked(acc + 2 * n_pad + r.i, r.p.y * r.sg - r.sgy, flag);
  fixed_point::add_checked(acc + 3 * n_pad + r.i, r.p.z * r.sg - r.sgz, flag);
}

template <int MODE>
int launch_tri(const float4* a, const int* rs, const int* rc, const int* ci, const int* cq, const float* sc,
               float4* o, unsigned long long* ac, int n_rows, const Series& s, cudaStream_t st) {
  tri_kernel<MODE><<<dim3(n_rows, SPLITS), THREADS, 0, st>>>(a, rs, rc, ci, cq, sc, ac, n_rows, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_store_checked(o, ac, n_rows * ROW, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_rows,) i32, col_ids i32,
// rcen_q (n_rows * 4,) i32, scal (4,) f32, out (Npad, 4) f32, acc (4 Npad
// + 1,) i64 set to zero (triangular only). h and p are host arrays of 11
// floats. mode: 0 forces, 1 forces + energy; triangular: 0 symmetric lists
// (the first design), 1 Newton-triangular (the redesign). Any other form
// returns cudaErrorInvalidValue and launches nothing; else the first CUDA
// error, or 0.
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
  if (triangular) {
    if (mode == FORCE) return launch_tri<FORCE>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
    if (mode == FORCE_ENERGY) return launch_tri<FORCE_ENERGY>(a, rs, rc, ci, cq, sc, o, ac, n_rows, s, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == FORCE) {
    sym_kernel<FORCE><<<n_rows, THREADS, 0, st>>>(a, rs, rc, ci, cq, sc, o, s);
  } else if (mode == FORCE_ENERGY) {
    sym_kernel<FORCE_ENERGY><<<n_rows, THREADS, 0, st>>>(a, rs, rc, ci, cq, sc, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
