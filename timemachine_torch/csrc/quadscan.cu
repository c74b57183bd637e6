// Quadscan pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_quadscan_kernel` of
// timemachine_tpu/ops/pallas/quadscan_kernel.py (pallas_call :291; the MD
// provider of the `kernel="quad"` configuration), in its two modes, forces
// (every MD step) and forces + energy (the barostat's trial energies), with
// or without the 4D w lift (JAX's `has_w`). Plain PyTorch version:
// quadscan_sweep_plain in timemachine_torch/ops/quadscan_kernel.py.
//
// What it computes: Hilbert-sorted atoms in 32-atom chunks, each chunk both
// a row chunk and a column quarter. Row chunk r lists the quarters c >= r
// within the list cutoff, its own first, each entry carrying the image shift
// to add to the quarter's coordinates (one shift is right for every pair of
// the entry; the builder checks the invariant). Each pair within the cutoff
// is visited once, with the pair function of pair_math.cuh and no per-pair
// minimum image (without w, r2 has no dw term); on the diagonal entry only
// row atom < column atom. The row atom gets the energy (row-side u) and the
// gradient, the column atom the reaction. Output per atom: [u_i, dU/dx_i].
//
// What bounds it on the card: FP32 issue. At solvated DHFR (744 chunks,
// about 68,700 listed entries at cutoff + skin) the lists hold 70.4M pair
// slots for 8.3M pairs within the cutoff, each slot one rsqrt and about 45
// FP32 instructions. The first design (kept below as `first_kernel`, F mode
// with w, the yardstick) swept every slot and handed each column atom and
// its reaction round the warp with 10 shuffles per slot, a quarter of the
// FP32 issue rate each, in one block of 4 warps per row chunk whose longest
// lists set the tail.
//
// What the redesign does about it:
// * a per-step cull at the bare cutoff + CULL_SLACK: each column atom of a
//   listed entry, shifted, is tested against the box of the row chunk's
//   atoms as placed (formed in the warp by shuffles). The box holds the very
//   positions the pair function subtracts, the gap bounds each pair's
//   distance from below in its arithmetic, and w only adds to r2, so the
//   cull drops no pair within the cutoff. (An entry cull of each shifted
//   quarter's box before its copy was tried: it needs a box pass of its own
//   and saves only the copies of the ~13% of entries it drops; PERF.md has
//   the two forms' times on an H100);
// * the live columns of a warp's consecutive entries are compacted, by ballot
//   and prefix in entry and lane order (deterministic), into a ring of 64
//   shared-memory slots (live_columns.cuh), each with its shifted position,
//   parameters, sorted index and diagonal gate, and swept in chunks of 32.
//   Each lane holds two row atoms (l % 16 and l % 16 + 16), and half-warp h
//   takes the chunk's slots 16 h .. 16 h + 15: lane l pairs both its rows
//   with slot 16 h + (l + k) % 16 at step k, reading the column from shared
//   memory once for two pairs, and carries that slot's reaction, handed on
//   within the half-warp by three shuffles a step (nb_tiles.cu's pattern, at
//   half the shuffles and reads per pair); after 16 steps lane l holds slot
//   l's whole sum. No barrier: every warp works alone;
// * work items of (row chunk, list piece): each row's entries are cut into
//   SPLITS x WARPS near-equal pieces, one per warp of SPLITS blocks, so no
//   warp carries a long list alone (of 1, 2, 4 and 8 blocks, 4 ran fastest
//   at DHFR on an H100); the warp reads 32 entries at once, one per lane, and
//   takes their quarters by cp.async in a ring of STAGES stages per warp,
//   STAGES - 1 entries ahead (each lane copies, and later reads, its own
//   column atom);
// * row sums and reactions go into one int64 fixed-point accumulator
//   (fixed_point.cuh) by integer atomics, which are order-free: two launches
//   are bitwise equal. A sum past the accumulator's range (a near-overlap in
//   a barostat trial) turns the whole result into NaN, never a wrapped
//   finite sum. A last pass converts the sums to f32;
// * padding entries (the builder's last quarter, all padding) are culled and
//   swept like any other, as the plain version computes them: padding atoms
//   carry q = eps = 0 and add exact zeros, and an entry that holds real atoms
//   loses no pair within the cutoff, whatever the caller's lists.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fixed_point.cuh"
#include "live_columns.cuh"
#include "pair_math.cuh"

using namespace live_columns;
using namespace pair_math;

namespace {

constexpr int Q = 32;     // atoms per row chunk and per column quarter
constexpr int PACK = 4;   // quarters per listed tile
constexpr int SHIFT_BITS = 12;  // quarter id in bits 0-11, (shift + 1) per axis in bits 12-17
constexpr int CID_MASK = (1 << SHIFT_BITS) - 1;

__device__ __forceinline__ float image(int code, int axis) {
  return static_cast<float>(((code >> (SHIFT_BITS + 2 * axis)) & 3) - 1);
}

// -- the first design: the yardstick, F mode with w --------------------------------

constexpr int FIRST_WARPS = PACK;
constexpr int FIRST_THREADS = FIRST_WARPS * 32;

__global__ void __launch_bounds__(FIRST_THREADS) first_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count,  // in tiles of PACK entries
    const int* __restrict__ entries,
    const float* __restrict__ scal,            // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,                  // (Npad) row parts [u, dU/dx, dU/dy, dU/dz]
    unsigned long long* __restrict__ acc,      // (3, Npad) fixed-point column parts, zeroed
    int n_rows, const Series s) {
  __shared__ float4 part[FIRST_WARPS][Q];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int i = row * Q + lane;
  const int n_pad = n_rows * Q;

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float cut2 = cutoff * cutoff;

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int* list = entries + static_cast<size_t>(row_start[row]) * PACK;
  const int n_entries = row_count[row] * PACK;
  for (int k = warp; k < n_entries; k += FIRST_WARPS) {
    const int code = list[k];
    const int cid = code & CID_MASK;
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
      pair_terms<FORCE>(dx, dy, dz, ra.w - cw, rb.x * cq, rb.y + cs, rb.z * ce, cut2, !diag || lane < src, s, de_r,
                        e);
      const float tx = de_r * dx, ty = de_r * dy, tz = de_r * dz;
      gx += tx;
      gy += ty;
      gz += tz;
      fx -= tx;
      fy -= ty;
      fz -= tz;
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

  part[warp][lane] = make_float4(0.0f, gx, gy, gz);
  __syncthreads();
  if (warp == 0) {
    float4 sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < FIRST_WARPS; ++w) {
      const float4 p = part[w][lane];
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    out[i] = sum;
  }
}

// -- the redesign -------------------------------------------------------------------

constexpr int WARPS = 4;   // warps per block, one list piece each
constexpr int THREADS = WARPS * 32;
constexpr int SPLITS = 4;  // blocks per row chunk (quadscan_kernel.SPLITS mirrors it)

// squared gap between the point p and the box [lo, hi]
__device__ __forceinline__ float gap2(float3 lo, float3 hi, float3 p) {
  const float gx = fmaxf(fmaxf(p.x - hi.x, lo.x - p.x), 0.0f);
  const float gy = fmaxf(fmaxf(p.y - hi.y, lo.y - p.y), 0.0f);
  const float gz = fmaxf(fmaxf(p.z - hi.z, lo.z - p.z), 0.0f);
  return gx * gx + gy * gy + gz * gz;
}

// A row atom of a lane: position [x y z w], parameters [q sigma/2
// 2sqrt(eps) 0], sorted index, sums [u, dU/dx]
struct RowAtom {
  float4 p, q;
  int i;
  float4 sum;
};

// One pair: row atom r against the column atom (cp, cq; gate index in
// cq.w), its terms added to r's sums; returns the row's force part t.
template <int MODE, bool W>
__device__ __forceinline__ void pair_into(RowAtom& r, const float4& cp, const float4& cq, float cut2, const Series& s,
                                          float& tx, float& ty, float& tz) {
  const float dx = r.p.x - cp.x;
  const float dy = r.p.y - cp.y;
  const float dz = r.p.z - cp.z;
  float r2 = dx * dx + dy * dy + dz * dz;
  if (W) {
    const float dw = r.p.w - cp.w;
    r2 += dw * dw;
  }
  float de_r, e;
  pair_terms_r2<MODE>(r2, r.q.x * cq.x, r.q.y + cq.y, r.q.z * cq.z, cut2, r.i < __float_as_int(cq.w), s, de_r, e);
  tx = de_r * dx;
  ty = de_r * dy;
  tz = de_r * dz;
  r.sum.y += tx;
  r.sum.z += ty;
  r.sum.w += tz;
  if (MODE == FORCE_ENERGY) r.sum.x += e;
}

// One chunk of the warp's ring (live_columns.cuh), slots base .. base + 31,
// the first n live: lane l pairs its two row atoms (rows l % 16 and
// l % 16 + 16) with slot_at(base, l, k) at step k and carries that slot's
// reaction, handed on within the half-warp by three shuffles a step; after
// 16 steps lane l holds slot l's whole reaction and adds it in fixed point
// (checked: the flag follows the four planes of acc).
template <int MODE, bool W>
__device__ __forceinline__ void sweep_chunk(const WarpSmem& sm, int base, int n, int lane, RowAtom& a, RowAtom& b,
                                            float cut2, const Series& s, unsigned long long* __restrict__ acc,
                                            int n_pad) {
  const int from = next_lane(lane);
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;  // the reaction of slot_at(base, lane, k) at step k
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const int slot = slot_at(base, lane, k);
    const float4 cp = sm.pos[slot];
    const float4 cq = sm.par[slot];
    float tx, ty, tz;
    pair_into<MODE, W>(a, cp, cq, cut2, s, tx, ty, tz);
    fx -= tx;
    fy -= ty;
    fz -= tz;
    pair_into<MODE, W>(b, cp, cq, cut2, s, tx, ty, tz);
    fx -= tx;
    fy -= ty;
    fz -= tz;
    // hand the reactions on: lane l now carries slot_at(base, l, k + 1)
    fx = __shfl_sync(FULL, fx, from);
    fy = __shfl_sync(FULL, fy, from);
    fz = __shfl_sync(FULL, fz, from);
  }
  if (lane < n) {
    unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
    const int j = sm.idx[(base + lane) & (RING - 1)];
    fixed_point::add_checked(acc + n_pad + j, fx, flag);
    fixed_point::add_checked(acc + 2 * n_pad + j, fy, flag);
    fixed_point::add_checked(acc + 3 * n_pad + j, fz, flag);
  }
}

// v += its value in the other half-warp (the same row atom's other columns)
__device__ __forceinline__ void add_halves(float4& v) {
  v.x += __shfl_xor_sync(FULL, v.x, 16);
  v.y += __shfl_xor_sync(FULL, v.y, 16);
  v.z += __shfl_xor_sync(FULL, v.z, 16);
  v.w += __shfl_xor_sync(FULL, v.w, 16);
}

template <int MODE, bool W>
__global__ void __launch_bounds__(THREADS) sweep_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count,  // in tiles of PACK entries
    const int* __restrict__ entries,
    const float* __restrict__ scal,        // [box_x, box_y, box_z, cutoff]
    unsigned long long* __restrict__ acc,  // (4 Npad + 1) fixed-point [u, dU/dx, dU/dy, dU/dz], then the flag; zeroed
    int n_rows, const Series s) {
  __shared__ WarpSmem smem[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  // this warp's piece [k0, k1) of the row's entries
  constexpr int PIECES = SPLITS * WARPS;
  const int piece = blockIdx.y * WARPS + warp;
  const int len = row_count[row] * PACK;
  const int k0 = len * piece / PIECES;
  const int k1 = len * (piece + 1) / PIECES;
  if (k0 == k1) return;  // the warp only: the block has no barrier

  WarpSmem& sm = smem[warp];
  const int n_pad = n_rows * Q;
  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float cut2 = cutoff * cutoff;
  const float cull = cutoff + CULL_SLACK;
  const float cull2 = cull * cull;
  const int ia = row * Q + (lane & 15);
  RowAtom a{atoms[2 * ia], atoms[2 * ia + 1], ia, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  RowAtom b{atoms[2 * (ia + 16)], atoms[2 * (ia + 16) + 1], ia + 16, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  // the row chunk's box as placed (padding atoms included)
  const float3 rlo = make_float3(warp_min(fminf(a.p.x, b.p.x)), warp_min(fminf(a.p.y, b.p.y)),
                                 warp_min(fminf(a.p.z, b.p.z)));
  const float3 rhi = make_float3(warp_max(fmaxf(a.p.x, b.p.x)), warp_max(fmaxf(a.p.y, b.p.y)),
                                 warp_max(fmaxf(a.p.z, b.p.z)));
  const int* list = entries + static_cast<size_t>(row_start[row]) * PACK;

  int head = 0, tail = 0;  // live columns written / swept (warp-uniform)
  constexpr int AHEAD = STAGES - 1;
  for (int e0 = k0; e0 < k1; e0 += 32) {
    // up to 32 entries at once: lane l reads entry e0 + l
    const int n_entries = min(32, k1 - e0);
    const int code_own = lane < n_entries ? list[e0 + lane] : 0;
    int n_issued = 0;
    auto issue = [&]() {  // lane l copies column atom l of the next entry's quarter into its stage
      const int cid = __shfl_sync(FULL, code_own, n_issued) & CID_MASK;
      const float4* src = atoms + 2 * (static_cast<size_t>(cid) * Q + lane);
      float4* dst = &sm.stage[n_issued++ & (STAGES - 1)][2 * lane];
      cp_async16(dst, src);
      cp_async16(dst + 1, src + 1);
      cp_async_commit();
    };
    __syncwarp();  // this lane's reads of the stages of the last batch are done
    for (int t = 0; t < AHEAD && n_issued < n_entries; ++t) issue();
    for (int t = 0; t < n_entries; ++t) {
      __syncwarp();  // this lane's reads of the stage the next copy overwrites are done
      if (n_issued < n_entries) {
        issue();
        cp_async_wait<AHEAD>();
      } else {
        cp_async_wait<0>();
      }
      const int c = __shfl_sync(FULL, code_own, t);
      const int cid = c & CID_MASK;
      const int st = t & (STAGES - 1);
      float4 cp = sm.stage[st][2 * lane];
      const float4 cq = sm.stage[st][2 * lane + 1];
      cp.x += image(c, 0) * bx;
      cp.y += image(c, 1) * by;
      cp.z += image(c, 2) * bz;
      const int j = cid * Q + lane;
      head += push(sm, head, lane, gap2(rlo, rhi, make_float3(cp.x, cp.y, cp.z)) < cull2, cp, cq,
                   cid == row ? j : NO_GATE, j);
      if (head - tail >= Q) {
        __syncwarp();  // the chunk's slots are written
        sweep_chunk<MODE, W>(sm, tail, Q, lane, a, b, cut2, s, acc, n_pad);
        tail += Q;
        __syncwarp();  // every lane is done with the chunk before its slots are written again
      }
    }
  }
  if (head > tail) {  // the last chunk, padded with dead slots
    fill_dead(sm, tail, head - tail, lane);
    sweep_chunk<MODE, W>(sm, tail, head - tail, lane, a, b, cut2, s, acc, n_pad);
  }
  // each half-warp swept half of every chunk: add the halves, then lane l
  // adds row l's sums (rows l % 16 in the first half-warp, l % 16 + 16 in the second)
  add_halves(a.sum);
  add_halves(b.sum);
  const float4 sum = lane < 16 ? a.sum : b.sum;
  const int i = row * Q + lane;
  unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
  if (MODE == FORCE_ENERGY) fixed_point::add_checked(acc + i, sum.x, flag);
  fixed_point::add_checked(acc + n_pad + i, sum.y, flag);
  fixed_point::add_checked(acc + 2 * n_pad + i, sum.z, flag);
  fixed_point::add_checked(acc + 3 * n_pad + i, sum.w, flag);
}

struct Launch {
  const float4* atoms;
  const int *row_start, *row_count, *entries;
  const float* scal;
  float4* out;
  unsigned long long* acc;
  int n_rows;
  Series s;
  cudaStream_t stream;
};

template <int MODE, bool W>
int launch(const Launch& a) {
  sweep_kernel<MODE, W><<<dim3(a.n_rows, SPLITS), THREADS, 0, a.stream>>>(
      a.atoms, a.row_start, a.row_count, a.entries, a.scal, a.acc, a.n_rows, a.s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_store_checked(a.out, a.acc, a.n_rows * Q, a.stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_rows,) i32, entries i32, scal
// (4,) f32, out (Npad, 4) f32, acc (4 Npad + 1,) i64 set to zero. h and p
// are host arrays of 11 floats. mode: 0 forces, 1 forces + energy; has_w 0
// or 1. first_design 1 runs the first design's kernel (F mode with w only;
// acc's first 3 planes as its column parts). Any other form returns
// cudaErrorInvalidValue and launches nothing; else the first CUDA error, or 0.
extern "C" int quadscan_sweep_launch(const void* atoms, const void* row_start, const void* row_count,
                                     const void* entries, const void* scal, void* out, void* acc, int n_rows,
                                     int mode, int has_w, int first_design, const float* h, const float* p,
                                     void* stream) {
  const Launch a{static_cast<const float4*>(atoms),
                 static_cast<const int*>(row_start),
                 static_cast<const int*>(row_count),
                 static_cast<const int*>(entries),
                 static_cast<const float*>(scal),
                 static_cast<float4*>(out),
                 static_cast<unsigned long long*>(acc),
                 n_rows,
                 make_series(h, p),
                 static_cast<cudaStream_t>(stream)};
  if (first_design) {
    if (mode != FORCE || !has_w) return static_cast<int>(cudaErrorInvalidValue);
    first_kernel<<<n_rows, FIRST_THREADS, 0, a.stream>>>(a.atoms, a.row_start, a.row_count, a.entries, a.scal, a.out,
                                                         a.acc, n_rows, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fixed_point::launch_add_columns(a.out, a.acc, n_rows * Q, a.stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == FORCE) return has_w ? launch<FORCE, true>(a) : launch<FORCE, false>(a);
  if (mode == FORCE_ENERGY) return has_w ? launch<FORCE_ENERGY, true>(a) : launch<FORCE_ENERGY, false>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
