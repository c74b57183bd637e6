// Gather pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_kernel` of
// timemachine_tpu/ops/pallas/gather_kernel.py (pallas_call :210; the MD
// provider and the energy/force of the `kernel="gather"` configuration), in
// its two modes: forces (every MD step) and forces + energy (the stateless
// energy/force, the barostat's trial energies). Plain PyTorch version:
// gather_sweep_plain in timemachine_torch/ops/gather_kernel.py.
//
// What it computes, per atom i: [u_i, dU/dx_i], u_i half of atom i's pair
// energies, over FULL lists (JAX's): atoms in snake order, cut into 32-atom
// row chunks; chunk r lists, in ascending order, every sorted slot within
// the list cutoff of its atoms' bounding box, the self pairs and padding
// slots included (the gate (r2 < cutoff^2) & (r2 > 1e-7) and their
// q = eps = 0 rows remove them). The pair function is pair_math.cuh's, with
// per-pair minimum image and w in r2.
//
// What bounds it on the card: FP32 issue. At solvated DHFR (737 row
// chunks) the lists at cutoff + skin hold about 64.5M ordered pair slots, 7.7
// per pair within the cutoff, each one rsqrt and about 55 FP32 instructions
// with the minimum image. The first design (kept below as `first_kernel`, F
// mode, the yardstick) swept every listed slot from both sides, since the
// TPU kernel avoided scatter (about 9 ns an update on XLA:TPU) by computing
// each pair twice, and one block per row chunk let the longest lists set
// the tail.
//
// What the redesign does about it:
// * the Newton-triangular suffix of the full lists: take a pair i < j within
//   the cutoff, in sorted slots, i in row chunk r. Then j is within the list
//   cutoff of the box that holds i, so r's list holds j, and since the list
//   ascends, r's list from its first slot >= 32 r on (`tri_start[r]`) holds
//   every pair of r's atoms with a later atom. The sweep takes that suffix
//   only; on the row's own chunk it pairs row slot < column slot (the gate
//   index of live_columns.cuh), so each pair is computed once, its force on
//   both atoms and, in F+U, half its energy on each, which is the full-list
//   function's u_i;
// * a per-step column cull at the bare cutoff + CULL_SLACK: the warp forms
//   its row chunk's box by shuffles, from the row atoms at their images
//   nearest the chunk's first atom (a box of wrapped coordinates would span
//   the cell wherever a chunk straddles a face), with center c and
//   half-extent h. A column atom j is kept where the gap
//   g_a = max(|minimg(x_j - c)_a| - h_a, 0) gives g^2 < (cutoff + slack)^2.
//   That drops no pair within the cutoff: for a row atom i at its image i'
//   in the box, on each axis |minimg(c - x_j)| <= |c - x_i'| +
//   |minimg(x_i - x_j)| <= h + |d_a|, where d_a is the pair function's own
//   minimum-image difference; so g_a <= |d_a|, g^2 <= r2 in 3D, and w only
//   adds to r2;
// * the live columns of a warp's list piece are compacted, by ballot and
//   prefix in list order (deterministic), into the 64-slot ring of
//   live_columns.cuh, each with its position, parameters, sorted index and
//   gate, and swept in chunks of 32. Each lane holds two row atoms (l % 16
//   and l % 16 + 16), and half-warp h takes the chunk's slots 16 h .. 16 h +
//   15: lane l pairs both its rows with slot 16 h + (l + k) % 16 at step k
//   and carries that slot's reactions (three, and the energy in F+U),
//   handed on within the half-warp by shuffles; after 16 steps lane l holds
//   slot l's whole sum. No barrier: every warp works alone;
// * work items of (row chunk, list piece): each row's suffix is cut into
//   SPLITS x WARPS near-equal pieces, one per warp of SPLITS blocks (in
//   snake order the suffix is nearly the whole list for the first rows and
//   nearly empty for the last, so the pieces carry the balance; of 1, 2 and
//   4 blocks per row chunk, PERF.md gives the times on an H100); the warp
//   reads 32 list slots at once, one per lane, and each lane copies its own
//   column atom by cp.async into a ring of STAGES stages, STAGES - 1 ahead,
//   and later reads only that atom, so the scattered gathers need no
//   barrier;
// * row sums and reactions go into one int64 fixed-point accumulator
//   (fixed_point.cuh) by integer atomics, which are order-free: two launches
//   are bitwise equal. A sum past the accumulator's range (a near-overlap in
//   a barostat trial) turns the whole result into NaN, never a wrapped
//   finite sum. A last pass converts the sums to f32;
// * padding slots stay in the lists and are culled and swept like any
//   other: their q = eps = 0 rows add exact zeros.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fixed_point.cuh"
#include "live_columns.cuh"
#include "pair_math.cuh"

using namespace live_columns;
using namespace pair_math;

namespace {

constexpr int ROW = 32;  // atoms per row chunk

struct Box {
  float bx, by, bz, ibx, iby, ibz;
};

__device__ __forceinline__ Box make_box(const float* scal) {
  return Box{scal[0], scal[1], scal[2], 1.0f / scal[0], 1.0f / scal[1], 1.0f / scal[2]};
}

// v - b rint(v / b): the minimum image of a difference on one axis
__device__ __forceinline__ float min_image(float v, float b, float ib) { return v - b * rintf(v * ib); }

// -- the first design: the yardstick, F mode over the full lists ---------------------

constexpr int FIRST_RUN = 128;  // list slots staged at once
constexpr int FIRST_WARPS = 4;
constexpr int FIRST_THREADS = FIRST_WARPS * 32;
constexpr int FIRST_SLOTS_PER_WARP = FIRST_RUN / FIRST_WARPS;

// One block of 4 warps per row chunk; lane l owns row atom l, warp w sweeps
// 32 of each staged 128-slot run (every shared-memory read a broadcast), the
// next run's atoms fetched into registers while the current one is swept;
// the warps' partial sums are added in a fixed order.
__global__ void __launch_bounds__(FIRST_THREADS) first_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ counts,    // (nR,)
    const int* __restrict__ nbr,       // (nR, max_nbrs) sorted slots
    const float* __restrict__ scal,    // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,          // (Npad) [0, dU/dx, dU/dy, dU/dz]
    int max_nbrs, const Series s) {
  __shared__ float4 tile[2 * FIRST_RUN];
  __shared__ float4 part[FIRST_WARPS][ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;

  const Box box = make_box(scal);
  const float cut2 = scal[3] * scal[3];

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int count = min(counts[row], max_nbrs);
  const int* list = nbr + static_cast<size_t>(row) * max_nbrs;

  // thread t stages slot base + t of the list
  float4 next0 = make_float4(0.f, 0.f, 0.f, 0.f), next1 = next0;
  if (tid < count) {
    const int j = list[tid];
    next0 = atoms[2 * j];
    next1 = atoms[2 * j + 1];
  }
  for (int base = 0; base < count; base += FIRST_RUN) {
    __syncthreads();  // every warp is done with the previous run
    tile[2 * tid] = next0;
    tile[2 * tid + 1] = next1;
    __syncthreads();
    const int k = base + FIRST_RUN + tid;
    if (k < count) {
      const int j = list[k];
      next0 = atoms[2 * j];
      next1 = atoms[2 * j + 1];
    }
    const int first = warp * FIRST_SLOTS_PER_WARP;
    const int last = min(first + FIRST_SLOTS_PER_WARP, count - base);
#pragma unroll 4
    for (int jj = first; jj < last; ++jj) {
      const float4 ca = tile[2 * jj];
      const float4 cb = tile[2 * jj + 1];
      const float dx = min_image(ra.x - ca.x, box.bx, box.ibx);
      const float dy = min_image(ra.y - ca.y, box.by, box.iby);
      const float dz = min_image(ra.z - ca.z, box.bz, box.ibz);
      float de_r, e;
      pair_terms<FORCE>(dx, dy, dz, ra.w - ca.w, rb.x * cb.x, rb.y + cb.y, rb.z * cb.z, cut2, true, s, de_r, e);
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
    for (int w = 1; w < FIRST_WARPS; ++w) {
      const float4 p = part[w][lane];
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    out[i] = acc;
  }
}

// -- the redesign -------------------------------------------------------------------

constexpr int WARPS = 4;  // warps per block, one list piece each
constexpr int THREADS = WARPS * 32;
constexpr int SPLITS = 2;  // blocks per row chunk (gather_kernel.SPLITS mirrors it)

// A row atom of a lane: position [x y z w], parameters [q sigma/2
// 2sqrt(eps) 0], sorted index, sums [u, dU/dx]
struct RowAtom {
  float4 p, q;
  int i;
  float4 sum;
};

// One pair: row atom r against the column atom (cp, cq; gate index in
// cq.w), its terms added to r's sums; returns the row's force part t and
// the pair energy e (0 in F mode).
template <int MODE>
__device__ __forceinline__ void pair_into(RowAtom& r, const float4& cp, const float4& cq, const Box& box, float cut2,
                                          const Series& s, float& tx, float& ty, float& tz, float& e) {
  const float dx = min_image(r.p.x - cp.x, box.bx, box.ibx);
  const float dy = min_image(r.p.y - cp.y, box.by, box.iby);
  const float dz = min_image(r.p.z - cp.z, box.bz, box.ibz);
  float de_r;
  pair_terms<MODE>(dx, dy, dz, r.p.w - cp.w, r.q.x * cq.x, r.q.y + cq.y, r.q.z * cq.z, cut2,
                   r.i < __float_as_int(cq.w), s, de_r, e);
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
// reaction (and in F+U its energy), handed on within the half-warp by
// shuffles; after 16 steps lane l holds slot l's whole sum and adds it in
// fixed point (checked: the flag follows the four planes of acc).
template <int MODE>
__device__ __forceinline__ void sweep_chunk(const WarpSmem& sm, int base, int n, int lane, RowAtom& a, RowAtom& b,
                                            const Box& box, float cut2, const Series& s,
                                            unsigned long long* __restrict__ acc, int n_pad) {
  const int from = next_lane(lane);
  float fx = 0.0f, fy = 0.0f, fz = 0.0f, fu = 0.0f;  // the sums of slot_at(base, lane, k) at step k
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const int slot = slot_at(base, lane, k);
    const float4 cp = sm.pos[slot];
    const float4 cq = sm.par[slot];
    float tx, ty, tz, e;
    pair_into<MODE>(a, cp, cq, box, cut2, s, tx, ty, tz, e);
    fx -= tx;
    fy -= ty;
    fz -= tz;
    if (MODE == FORCE_ENERGY) fu += e;
    pair_into<MODE>(b, cp, cq, box, cut2, s, tx, ty, tz, e);
    fx -= tx;
    fy -= ty;
    fz -= tz;
    if (MODE == FORCE_ENERGY) fu += e;
    // hand the sums on: lane l now carries slot_at(base, l, k + 1)
    fx = __shfl_sync(FULL, fx, from);
    fy = __shfl_sync(FULL, fy, from);
    fz = __shfl_sync(FULL, fz, from);
    if (MODE == FORCE_ENERGY) fu = __shfl_sync(FULL, fu, from);
  }
  if (lane < n) {
    unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
    const int j = sm.idx[(base + lane) & (RING - 1)];
    if (MODE == FORCE_ENERGY) fixed_point::add_checked(acc + j, 0.5f * fu, flag);  // half of each pair energy
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

template <int MODE>
__global__ void __launch_bounds__(THREADS) sweep_kernel(
    const float4* __restrict__ atoms,   // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ counts,     // (nR,)
    const int* __restrict__ nbr,        // (nR, max_nbrs) sorted slots, ascending
    const int* __restrict__ tri_start,  // (nR,) listed slots below 32 r
    const float* __restrict__ scal,     // [box_x, box_y, box_z, cutoff]
    unsigned long long* __restrict__ acc,  // (4 Npad + 1) fixed-point [u, dU/dx, dU/dy, dU/dz], then the flag; zeroed
    int n_rows, int max_nbrs, const Series s) {
  __shared__ WarpSmem smem[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  // this warp's piece [k0, k1) of the row's suffix
  constexpr int PIECES = SPLITS * WARPS;
  const int piece = blockIdx.y * WARPS + warp;
  const int count = min(counts[row], max_nbrs);
  const int start = min(tri_start[row], count);
  const int len = count - start;
  const int k0 = start + len * piece / PIECES;
  const int k1 = start + len * (piece + 1) / PIECES;
  if (k0 == k1) return;  // the warp only: the block has no barrier

  WarpSmem& sm = smem[warp];
  const int n_pad = n_rows * ROW;
  const Box box = make_box(scal);
  const float cut2 = scal[3] * scal[3];
  const float cull = scal[3] + CULL_SLACK;
  const float cull2 = cull * cull;
  const int ia = row * ROW + (lane & 15);
  RowAtom a{atoms[2 * ia], atoms[2 * ia + 1], ia, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  RowAtom b{atoms[2 * (ia + 16)], atoms[2 * (ia + 16) + 1], ia + 16, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};

  // the row chunk's box, of its atoms (padding included) at their images
  // nearest its first atom: center c, half-extent h
  float3 c, h;
  {
    const float x0 = __shfl_sync(FULL, a.p.x, 0), y0 = __shfl_sync(FULL, a.p.y, 0);
    const float z0 = __shfl_sync(FULL, a.p.z, 0);
    auto near0 = [](float x, float x0, float b, float ib) { return x - b * rintf((x - x0) * ib); };
    const float ax = near0(a.p.x, x0, box.bx, box.ibx), bbx = near0(b.p.x, x0, box.bx, box.ibx);
    const float ay = near0(a.p.y, y0, box.by, box.iby), bby = near0(b.p.y, y0, box.by, box.iby);
    const float az = near0(a.p.z, z0, box.bz, box.ibz), bbz = near0(b.p.z, z0, box.bz, box.ibz);
    const float lox = warp_min(fminf(ax, bbx)), hix = warp_max(fmaxf(ax, bbx));
    const float loy = warp_min(fminf(ay, bby)), hiy = warp_max(fmaxf(ay, bby));
    const float loz = warp_min(fminf(az, bbz)), hiz = warp_max(fmaxf(az, bbz));
    c = make_float3(0.5f * (lox + hix), 0.5f * (loy + hiy), 0.5f * (loz + hiz));
    h = make_float3(0.5f * (hix - lox), 0.5f * (hiy - loy), 0.5f * (hiz - loz));
  }
  const int own_end = (row + 1) * ROW;  // column slots below this are in the row's own chunk

  const int* list = nbr + static_cast<size_t>(row) * max_nbrs;
  // lane l's list slot of stage t, or -1 past the piece
  auto slot_of = [&](int t) {
    const int k = k0 + 32 * t + lane;
    return k < k1 ? list[k] : -1;
  };
  auto issue = [&](int t, int j) {  // lane l copies its column atom of stage t; a commit group per stage
    if (j >= 0) {
      float4* dst = &sm.stage[t & (STAGES - 1)][2 * lane];
      cp_async16(dst, atoms + 2 * static_cast<size_t>(j));
      cp_async16(dst + 1, atoms + 2 * static_cast<size_t>(j) + 1);
    }
    cp_async_commit();
  };
  static_assert(STAGES == 4, "the rotation of the staged slots below holds STAGES - 1 = 3 stages in flight");
  const int n_stages = (k1 - k0 + 31) / 32;
  // j0 .. j2: the slots of stages t .. t + 2 (copies in flight), j3 of stage t + 3 (read, not yet issued)
  int j0 = slot_of(0), j1 = slot_of(1), j2 = slot_of(2), j3 = slot_of(3);
  issue(0, j0);
  issue(1, j1);
  issue(2, j2);
  int head = 0, tail = 0;  // live columns written / swept (warp-uniform)
  for (int t = 0; t < n_stages; ++t) {
    __syncwarp();  // this lane's reads of the stage the next copy overwrites are done
    issue(t + 3, j3);
    const int j4 = slot_of(t + 4);
    cp_async_wait<STAGES - 1>();  // stage t is here
    const int st = t & (STAGES - 1);
    const float4 cp = sm.stage[st][2 * lane];
    const float4 cq = sm.stage[st][2 * lane + 1];
    const float gx = fmaxf(fabsf(min_image(cp.x - c.x, box.bx, box.ibx)) - h.x, 0.0f);
    const float gy = fmaxf(fabsf(min_image(cp.y - c.y, box.by, box.iby)) - h.y, 0.0f);
    const float gz = fmaxf(fabsf(min_image(cp.z - c.z, box.bz, box.ibz)) - h.z, 0.0f);
    const bool live = j0 >= 0 && gx * gx + gy * gy + gz * gz < cull2;
    head += push(sm, head, lane, live, cp, cq, j0 < own_end ? j0 : NO_GATE, j0);
    if (head - tail >= ROW) {
      __syncwarp();  // the chunk's slots are written
      sweep_chunk<MODE>(sm, tail, ROW, lane, a, b, box, cut2, s, acc, n_pad);
      tail += ROW;
      __syncwarp();  // every lane is done with the chunk before its slots are written again
    }
    j0 = j1;
    j1 = j2;
    j2 = j3;
    j3 = j4;
  }
  if (head > tail) {  // the last chunk, padded with dead slots
    fill_dead(sm, tail, head - tail, lane);
    sweep_chunk<MODE>(sm, tail, head - tail, lane, a, b, box, cut2, s, acc, n_pad);
  }
  // each half-warp swept half of every chunk: add the halves, then lane l
  // adds row l's sums (rows l % 16 in the first half-warp, l % 16 + 16 in the second)
  add_halves(a.sum);
  add_halves(b.sum);
  const float4 sum = lane < 16 ? a.sum : b.sum;
  const int i = row * ROW + lane;
  unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);
  if (MODE == FORCE_ENERGY) fixed_point::add_checked(acc + i, 0.5f * sum.x, flag);  // half of each pair energy
  fixed_point::add_checked(acc + n_pad + i, sum.y, flag);
  fixed_point::add_checked(acc + 2 * n_pad + i, sum.z, flag);
  fixed_point::add_checked(acc + 3 * n_pad + i, sum.w, flag);
}

template <int MODE>
int launch(const float4* atoms, const int* counts, const int* nbr, const int* tri_start, const float* scal,
           float4* out, unsigned long long* acc, int n_rows, int max_nbrs, const Series& s, cudaStream_t st) {
  sweep_kernel<MODE><<<dim3(n_rows, SPLITS), THREADS, 0, st>>>(atoms, counts, nbr, tri_start, scal, acc, n_rows,
                                                               max_nbrs, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_store_checked(out, acc, n_rows * ROW, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the sweep over n_rows row chunks on `stream`. Device pointers:
// atoms (Npad, 8) f32, counts (n_rows,) i32, nbr (n_rows, max_nbrs) i32,
// tri_start (n_rows,) i32, scal (4,) f32, out (Npad, 4) f32, acc (4 Npad +
// 1,) i64 set to zero. h and p are host arrays of 11 floats. mode: 0
// forces, 1 forces + energy. first_design 1 runs the first design's kernel
// over the full lists (F mode only; tri_start and acc unread). Any other
// form returns cudaErrorInvalidValue and launches nothing; else the first
// CUDA error, or 0.
extern "C" int gather_sweep_launch(const void* atoms, const void* counts, const void* nbr, const void* tri_start,
                                   const void* scal, void* out, void* acc, int n_rows, int max_nbrs, int mode,
                                   int first_design, const float* h, const float* p, void* stream) {
  const Series s = make_series(h, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* c = static_cast<const int*>(counts);
  const int* nb = static_cast<const int*>(nbr);
  const int* ts = static_cast<const int*>(tri_start);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  if (first_design) {
    if (mode != FORCE) return static_cast<int>(cudaErrorInvalidValue);
    first_kernel<<<n_rows, FIRST_THREADS, 0, st>>>(a, c, nb, sc, o, max_nbrs, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == FORCE) return launch<FORCE>(a, c, nb, ts, sc, o, ac, n_rows, max_nbrs, s, st);
  if (mode == FORCE_ENERGY) return launch<FORCE_ENERGY>(a, c, nb, ts, sc, o, ac, n_rows, max_nbrs, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
