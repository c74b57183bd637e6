// Nonbonded block-tile sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_nb_tile_kernel` (and `_nb_tile_kernel_vmem`, the
// same function with VMEM-resident arrays) of
// timemachine_tpu/ops/pallas/nonbonded_kernel.py, in all of its modes:
//   UF  energy + dU/dx          (the kernel="v1" energy/force path)
//   F   dU/dx only              (the kernel="v1" MD provider)
//   DP  dU/dp                   (the backward pass of every differentiable
//                                energy: forcefield-parameter gradients)
// Plain PyTorch version: nb_tiles_plain in
// timemachine_torch/ops/nonbonded_kernel.py.
//
// What it computes, per row atom i of a 128-atom row block: the sum over the
// atoms j of every listed column super-block (128 cb atoms) with
//   mask = valid_i & valid_j & (i != j) & (r2 < cutoff^2)
// where r2 is the 4D minimum-image distance, of
//   LJ  4 eps ((sig/r)^12 - (sig/r)^6),  sig = s_i + s_j, eps = e_i e_j
//   ES  qq erfc(beta r) sw(r) / r,       sw = cos^3((pi/2)(r/1.2)^8)
// The exact ES form uses erfc by Abramowitz & Stegun 7.1.26; the poly form
// evaluates h(u) = erfc(beta 1.2 u) sw and h'(u) as two Clenshaw series in
// u = r/1.2 whose coefficients are kernel parameters. DP always runs the
// exact form. Atom rows are [x y z w | q sig/2 sqrt(eps) valid]; padding
// rows are zero with valid = 0. Output per atom:
//   UF  [u_i, dU/dx_i]
//   F   [0,   dU/dx_i]
//   DP  [dU/dq_i, dU/d(sig/2)_i, dU/d sqrt(eps)_i, dU/dw_i]
// Newton-triangular lists (every path of the port) keep only the column
// super-blocks that reach the row block's diagonal; each pair is computed
// once, with i < j, its energy goes to the row atom i (u_i is no longer half
// of atom i's pair energies: only the sum is the energy) and its terms to
// both atoms. The symmetric lists of the first design visit every pair from
// both atoms and halve the energy; that design is kept, in DP and F only,
// as the yardstick the triangular form is timed against.
//
// What bounds it on the card: FP32 issue. The exact pair function is about
// 100 FP32 instructions a pair in DP (one rsqrt, exp, sin, cos and two
// reciprocals among them). Solvated DHFR at cb = 2 lists 6,606 symmetric
// tiles (216.5M pair slots) for 8.33M pairs within the cutoff: the first
// design swept all 216.5M, paying the whole function on every slot (a
// masked slot takes r2 := 1), three IEEE divisions for the minimum image,
// two more, IEEE cosf and sqrtf, in 186 blocks of 512 threads (at most two
// per SM, with a tail set by the longest lists).
//
// What the triangular design does about it:
// * Newton-triangular lists: 3,396 tiles, 111.3M slots at the DHFR start;
//   sub-tiles whose column group lies below the row group are skipped, the
//   diagonal one is gated on i < j (108.6M slots);
// * each warp owns 32 row atoms (a row group). Against each staged 32-atom
//   column group it first culls the 32 x 32 sub-tile whole
//   (warp-uniformly) where the minimum-image gap between the two groups'
//   bounding boxes is at least cutoff + CULL_SLACK (60.2M slots kept),
//   then each column atom whose own gap to the row group's box is (27.5M
//   kept); the live columns of a tile are compacted, by ballot, into a
//   list of the warp's own and swept in chunks of 32 (34.0M slots). The
//   boxes come from a first pass (group_boxes) over every 32-atom group,
//   at each group's images nearest its first atom, so an atom that crossed
//   a face does not stretch its group's box across the box. Any images
//   bound each pair's distance from below and w only adds to r2, so
//   neither cull drops a pair within the cutoff;
// * in a chunk, lane l pairs its row atom with live column (l + k) % 32 at
//   step k and carries that column's reaction, handed on to lane l - 1 by
//   one shuffle per value and step, so after 32 steps lane l holds column
//   l's whole sum: no shared-memory reduction, no barrier;
// * the pair function is division-free: minimum image d - b rint(d / b)
//   with 1 / b computed once, approximate reciprocals for 1 / (1 + p x) and
//   1 / sig, __expf and __sincosf (|sin| for sqrt(1 - cos^2)); it stays the
//   exact form, A&S 7.1.26 x cos^3, and agrees with the plain version to
//   about 1e-6 per column;
// * work items of (row block, list segment): each row's list is cut into
//   SPLITS segments, each a block of 4 warps (96-127 registers: 4-5 blocks
//   resident per SM). At DHFR the lists hold 0-39 tiles a row (18.3 on
//   average), so most segments hold one tile or none: the longest lists
//   no longer set a tail (on an H100, 32 segments ran faster than 16, 8
//   or 4, and an unroll of 8 faster than 2, 4 or 16).
//   Longer segments take their column super-blocks by cp.async in a ring
//   of STAGES shared-memory stages, one tile ahead;
// * row sums and column reactions go into one int64 fixed-point accumulator
//   (fixed_point.cuh) by integer atomics, which are order-free: two launches
//   are bitwise equal. A reaction or partial sum of FIX_LIMIT or more (half
//   the accumulator's range), or not finite, raises a flag that turns the
//   whole result into NaN; a final sum beyond FIX_LIMIT comes back NaN too
//   (fixed_point.cuh's add_checked and store_checked);
// * masked pairs take r2 := 1 before the rsqrt and every output term is a
//   select on the mask, so no 0 * inf from sig = 0, eps = 0 or padding
//   reaches a sum. Build without --use_fast_math;
// * box, beta and cutoff are read from a 5-float device array, so the host
//   never syncs.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "fixed_point.cuh"

namespace {

constexpr int BLOCK = 128;  // atoms per row block
constexpr int MAX_CB = 8;
constexpr int NCOEF = 13;  // degree-12 Chebyshev series
constexpr float INV_C = 1.0f / 1.2f;  // 1 / SWITCH_CUTOFF
constexpr float INV_C2 = 1.0f / (1.2f * 1.2f);
constexpr float PI = 3.14159265358979323846f;
constexpr float TWO_OVER_SQRT_PI = 2.0f / 1.7724538509055159f;

enum Mode { UF = 0, F = 1, DP = 2 };

struct Series {
  float h[NCOEF];   // h(u), Chebyshev on u in [0, 1]
  float hp[NCOEF];  // h'(u)
};

__device__ __forceinline__ float clenshaw(const float (&c)[NCOEF], float t2) {
  // Chebyshev series at t given t2 = 2 t
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int k = NCOEF - 1; k >= 1; --k) {
    const float b0 = t2 * b1 - b2 + c[k];
    b2 = b1;
    b1 = b0;
  }
  return 0.5f * t2 * b1 - b2 + c[0];
}

// The terms of one pair at r2m (r2, or 1 where masked): the energy e, its
// dE/dr / r, the switched erfc / r (s_r_sw, for dU/dq) and (sig/r)^6, ^12.
// FAST takes the intrinsics of the triangular form, else the IEEE calls of
// the first design.
struct Terms {
  float e, de_r, s_r_sw, t6, t12;
};

template <bool POLY, bool FAST>
__device__ __forceinline__ Terms pair_terms(float r2m, float qq, float sig, float eps, float beta, const Series& s) {
  Terms o;
  const float inv_r = rsqrtf(r2m);
  const float rr = r2m * inv_r;
  const float inv_r2 = inv_r * inv_r;
  const float s2 = sig * sig * inv_r2;
  o.t6 = s2 * s2 * s2;
  o.t12 = o.t6 * o.t6;
  const float eps4 = 4.0f * eps;
  const float e_lj = eps4 * (o.t12 - o.t6);
  const float dlj_r = eps4 * inv_r2 * (6.0f * o.t6 - 12.0f * o.t12);
  float e_es, des_r;
  if (POLY) {
    const float t2 = 2.0f * (2.0f * (rr * INV_C) - 1.0f);
    const float h = clenshaw(s.h, t2);
    const float hp = clenshaw(s.hp, t2);
    o.s_r_sw = h * inv_r;
    e_es = qq * o.s_r_sw;
    des_r = qq * inv_r2 * (hp * INV_C - h * inv_r);
  } else {
    const float v = r2m * INV_C2;
    const float v2 = v * v;
    const float u8 = v2 * v2;
    float cosu, sinu;
    if (FAST) {
      __sincosf((0.5f * PI) * u8, &sinu, &cosu);
      sinu = fabsf(sinu);
    } else {
      cosu = cosf((0.5f * PI) * u8);
      sinu = sqrtf(fmaxf(1.0f - cosu * cosu, 0.0f));
    }
    const float cos2 = cosu * cosu;
    const float sw = cos2 * cosu;
    const float dsw_dr = -12.0f * PI * u8 * inv_r * cos2 * sinu;
    const float x = beta * rr;
    const float gauss = FAST ? __expf(-x * x) : expf(-x * x);
    const float tt = FAST ? __fdividef(1.0f, 1.0f + 0.3275911f * x) : 1.0f / (1.0f + 0.3275911f * x);
    const float erfc_bar =
        gauss * tt *
        (0.254829592f + tt * (-0.284496736f + tt * (1.421413741f + tt * (-1.453152027f + tt * 1.061405429f))));
    const float s_r = erfc_bar * inv_r;
    const float ds_dr = -beta * TWO_OVER_SQRT_PI * gauss * inv_r - erfc_bar * inv_r2;
    e_es = qq * s_r * sw;
    des_r = qq * (ds_dr * sw + s_r * dsw_dr) * inv_r;
    o.s_r_sw = s_r * sw;
  }
  o.e = e_lj + e_es;
  o.de_r = dlj_r + des_r;
  return o;
}

// dU/d(sig/2) of one pair, 0 where masked or eps = 0 (its only term holds eps)
template <bool FAST>
__device__ __forceinline__ float d_sig(bool mask, float sig, float eps, const Terms& p) {
  const float sig_safe = sig > 0.0f ? sig : 1.0f;
  const float num = 4.0f * eps * (12.0f * p.t12 - 6.0f * p.t6);
  return (mask && eps != 0.0f) ? (FAST ? num * __fdividef(1.0f, sig_safe) : num / sig_safe) : 0.0f;
}

// -- symmetric lists: the first design --------------------------------------------

constexpr int GROUPS = 4;  // threads per row atom, each over a quarter of the columns
constexpr int SYM_THREADS = BLOCK * GROUPS;

__device__ __forceinline__ float min_image(float d, float box) { return d - box * floorf(d / box + 0.5f); }

template <int MODE>
__global__ void __launch_bounds__(SYM_THREADS) sym_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const float* __restrict__ scal,  // [box_x, box_y, box_z, beta, cutoff]
    float4* __restrict__ out,        // (Npad) 4 floats per atom, by mode
    const int cb, const Series s) {
  extern __shared__ float4 smem[];
  const int width = BLOCK * cb;
  float4* tile = smem;              // 2 * width: the staged column super-block
  float4* part = smem + 2 * width;  // GROUPS * BLOCK partial sums

  const int r = threadIdx.x % BLOCK;
  const int g = threadIdx.x / BLOCK;  // a warp's 32 threads share g
  const int i = blockIdx.x * BLOCK + r;

  const float bx = scal[0], by = scal[1], bz = scal[2], beta = scal[3], cutoff = scal[4];
  const float cut2 = cutoff * cutoff;

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rp = atoms[2 * i + 1];  // q sig/2 sqrt(eps) valid
  const bool valid_i = rp.w > 0.0f;

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  const int start = row_start[blockIdx.x];
  const int count = row_count[blockIdx.x];
  const int per_group = width / GROUPS;
  const int j0 = g * per_group;

  for (int k = 0; k < count; ++k) {
    const int c = col_ids[start + k];
    const float4* src = atoms + static_cast<size_t>(c) * (2 * width);
    __syncthreads();  // every thread is done with the previous super-block
    for (int t = threadIdx.x; t < 2 * width; t += SYM_THREADS) tile[t] = src[t];
    __syncthreads();
    for (int jj = 0; jj < per_group; ++jj) {
      const int j = j0 + jj;
      const float4 ca = tile[2 * j];
      const float4 cp = tile[2 * j + 1];
      const float dx = min_image(ra.x - ca.x, bx);
      const float dy = min_image(ra.y - ca.y, by);
      const float dz = min_image(ra.z - ca.z, bz);
      const float dw = ra.w - ca.w;
      const float r2 = dx * dx + dy * dy + dz * dz + dw * dw;
      const bool mask = valid_i && (cp.w > 0.0f) && (i != c * width + j) && (r2 < cut2);
      const float sig = rp.y + cp.y;
      const float eps = rp.z * cp.z;
      const Terms p = pair_terms<false, false>(mask ? r2 : 1.0f, rp.x * cp.x, sig, eps, beta, s);
      const float de_r = mask ? p.de_r : 0.0f;
      if (MODE == DP) {
        a0 += mask ? cp.x * p.s_r_sw : 0.0f;
        a1 += d_sig<false>(mask, sig, eps, p);
        a2 += mask ? cp.z * (4.0f * (p.t12 - p.t6)) : 0.0f;
        a3 += de_r * dw;
      } else {
        a1 += de_r * dx;
        a2 += de_r * dy;
        a3 += de_r * dz;
      }
    }
  }

  part[g * BLOCK + r] = make_float4(a0, a1, a2, a3);
  __syncthreads();
  if (g == 0) {
    float4 acc = part[r];
#pragma unroll
    for (int q = 1; q < GROUPS; ++q) {
      const float4 p = part[q * BLOCK + r];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    out[i] = acc;
  }
}

// -- Newton-triangular lists ------------------------------------------------------

constexpr int GROUP = 32;               // atoms per sub-tile side
constexpr int WARPS = BLOCK / GROUP;    // one per row group of the row block
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;               // cp.async ring of column super-blocks
constexpr int SPLITS = 32;              // list segments per row block, each a block
constexpr float CULL_SLACK = 1e-3f;     // nm, as nonbonded_kernel.CULL_SLACK
constexpr unsigned FULL = 0xffffffffu;

struct Frame {
  float bx, by, bz, ibx, iby, ibz, beta, cut2, cull2;
};

__device__ __forceinline__ Frame make_frame(const float* scal) {
  Frame f;
  f.bx = scal[0];
  f.by = scal[1];
  f.bz = scal[2];
  f.ibx = 1.0f / f.bx;
  f.iby = 1.0f / f.by;
  f.ibz = 1.0f / f.bz;
  f.beta = scal[3];
  f.cut2 = scal[4] * scal[4];
  const float cull = scal[4] + CULL_SLACK;
  f.cull2 = cull * cull;
  return f;
}

__device__ __forceinline__ float wrap(float d, float b, float ib) { return d - b * rintf(d * ib); }

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// boxes[2 g], boxes[2 g + 1] = center and half-extent of group g's valid
// atoms at their images nearest the group's first atom (half -1e18 where
// the group has none); one warp per group (nonbonded_kernel.subtile_boxes)
__global__ void group_boxes(const float4* __restrict__ atoms, const float* __restrict__ scal,
                            float4* __restrict__ boxes, int n_groups) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (g >= n_groups) return;  // whole warps
  const Frame f = make_frame(scal);
  const float4 p = atoms[2 * (g * GROUP + lane)];
  const bool valid = atoms[2 * (g * GROUP + lane) + 1].w > 0.0f;
  const float rx = __shfl_sync(FULL, p.x, 0), ry = __shfl_sync(FULL, p.y, 0), rz = __shfl_sync(FULL, p.z, 0);
  const float dx = wrap(p.x - rx, f.bx, f.ibx), dy = wrap(p.y - ry, f.by, f.iby), dz = wrap(p.z - rz, f.bz, f.ibz);
  const float inf = __int_as_float(0x7f800000);
  const float lx = warp_min(valid ? dx : inf), ly = warp_min(valid ? dy : inf), lz = warp_min(valid ? dz : inf);
  const float hx = warp_max(valid ? dx : -inf), hy = warp_max(valid ? dy : -inf), hz = warp_max(valid ? dz : -inf);
  const bool any = __any_sync(FULL, valid);
  if (lane == 0) {
    boxes[2 * g] = any ? make_float4(rx + 0.5f * (lx + hx), ry + 0.5f * (ly + hy), rz + 0.5f * (lz + hz), 0.0f)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    boxes[2 * g + 1] = any ? make_float4(0.5f * (hx - lx), 0.5f * (hy - ly), 0.5f * (hz - lz), 0.0f)
                           : make_float4(-1e18f, -1e18f, -1e18f, 0.0f);
  }
}

// whether two boxes (center, half-extent) come within cutoff + CULL_SLACK
// (subtile_near); a point is a box of no extent
__device__ __forceinline__ bool near(const float4& ca, const float4& ha, const float4& cb, const float4& hb,
                                     const Frame& f) {
  const float gx = fmaxf(fabsf(wrap(ca.x - cb.x, f.bx, f.ibx)) - (ha.x + hb.x), 0.0f);
  const float gy = fmaxf(fabsf(wrap(ca.y - cb.y, f.by, f.iby)) - (ha.y + hb.y), 0.0f);
  const float gz = fmaxf(fabsf(wrap(ca.z - cb.z, f.bz, f.ibz)) - (ha.z + hb.z), 0.0f);
  return gx * gx + gy * gy + gz * gz < f.cull2;
}

// One chunk of a warp's live columns: this lane's row atom (rp, rq; global
// index i) against the staged column atoms cidx[0 .. n) (at most 32; the
// rest of the chunk is dead), column global index col0 + cidx[.]. Each pair
// is gated on i < j, which only the row group's own column group can fail.
// On return lane l carries the reaction of column slot l.
template <int MODE, bool POLY>
__device__ __forceinline__ void chunk(const float4* __restrict__ pos, const float4* __restrict__ par,
                                      const int* __restrict__ cidx, int n, int col0, int lane, int i,
                                      const float4& rp, const float4& rq, const Frame& f, const Series& s,
                                      float4& row, float4& col) {
  const bool valid_i = rq.w > 0.0f;
  col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the reaction of slot (lane + k) % 32 at step k
#pragma unroll 8
  for (int k = 0; k < GROUP; ++k) {
    const int slot = (lane + k) & (GROUP - 1);
    const bool live = slot < n;
    const int a = live ? cidx[slot] : 0;
    const float4 cp = pos[a];
    const float4 cq = par[a];
    const float dx = wrap(rp.x - cp.x, f.bx, f.ibx);
    const float dy = wrap(rp.y - cp.y, f.by, f.iby);
    const float dz = wrap(rp.z - cp.z, f.bz, f.ibz);
    const float dw = rp.w - cp.w;
    const float r2 = dx * dx + dy * dy + dz * dz + dw * dw;
    const bool mask = live && valid_i && (i < col0 + a) && (r2 < f.cut2);
    const float sig = rq.y + cq.y;
    const float eps = rq.z * cq.z;
    const Terms p = pair_terms<POLY, true>(mask ? r2 : 1.0f, rq.x * cq.x, sig, eps, f.beta, s);
    const float de_r = mask ? p.de_r : 0.0f;
    if (MODE == DP) {
      const float ds = d_sig<true>(mask, sig, eps, p);
      const float lj = 4.0f * (p.t12 - p.t6);
      row.x += mask ? cq.x * p.s_r_sw : 0.0f;
      row.y += ds;
      row.z += mask ? cq.z * lj : 0.0f;
      row.w = fmaf(de_r, dw, row.w);
      col.x += mask ? rq.x * p.s_r_sw : 0.0f;
      col.y += ds;
      col.z += mask ? rq.z * lj : 0.0f;
      col.w = fmaf(-de_r, dw, col.w);
      col.x = __shfl_sync(FULL, col.x, (lane + 1) & (GROUP - 1));
    } else {
      if (MODE == UF) row.x += mask ? p.e : 0.0f;
      row.y = fmaf(de_r, dx, row.y);
      row.z = fmaf(de_r, dy, row.z);
      row.w = fmaf(de_r, dz, row.w);
      col.y = fmaf(-de_r, dx, col.y);
      col.z = fmaf(-de_r, dy, col.z);
      col.w = fmaf(-de_r, dz, col.w);
    }
    // hand the reactions on: lane l now carries slot (l + k + 1) % 32
    col.y = __shfl_sync(FULL, col.y, (lane + 1) & (GROUP - 1));
    col.z = __shfl_sync(FULL, col.z, (lane + 1) & (GROUP - 1));
    col.w = __shfl_sync(FULL, col.w, (lane + 1) & (GROUP - 1));
  }
}

template <int MODE, bool POLY>
__global__ void __launch_bounds__(THREADS, 4) tri_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const float4* __restrict__ boxes,  // (Npad / 32, 2) group boxes
    const int* __restrict__ row_start, const int* __restrict__ row_count, const int* __restrict__ col_ids,
    const float* __restrict__ scal,        // [box_x, box_y, box_z, beta, cutoff]
    unsigned long long* __restrict__ acc,  // (4, Npad) fixed-point sums by mode, then the overflow flag; zeroed
    int n_pad, int cb, const Series s) {
  // [STAGES][positions (width), parameters (width)] float4, then [WARPS][width] int live columns
  extern __shared__ float4 smem[];
  const int width = BLOCK * cb;
  const int row = blockIdx.x;
  // this block's segment [k0, k1) of the row's list
  const int count = row_count[row];
  const int k0 = count * blockIdx.y / gridDim.y;
  const int k1 = count * (blockIdx.y + 1) / gridDim.y;
  if (k0 == k1) return;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int rg = row * WARPS + warp;  // this warp's row group
  const int i = rg * GROUP + lane;
  const int start = row_start[row];
  const Frame f = make_frame(scal);
  const float4 rp = atoms[2 * i];
  const float4 rq = atoms[2 * i + 1];
  const float4 rbc = boxes[2 * rg], rbh = boxes[2 * rg + 1];
  int* cidx = reinterpret_cast<int*>(smem + STAGES * 2 * width) + warp * width;
  unsigned long long* flag = acc + 4 * static_cast<size_t>(n_pad);

  auto issue = [&](int k) {  // thread t copies atoms t, t + THREADS, ... of tile k into its stage
    const float4* src = atoms + static_cast<size_t>(col_ids[start + k]) * (2 * width);
    float4* dst = smem + (k % STAGES) * (2 * width);
    for (int a = t; a < width; a += THREADS) {
      cp_async16(dst + a, src + 2 * a);
      cp_async16(dst + width + a, src + 2 * a + 1);
    }
    cp_async_commit();
  };

  float4 rsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int groups = width / GROUP;
  issue(k0);
  for (int k = k0; k < k1; ++k) {
    if (k + 1 < k1) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // tile k is staged; every thread is done with the stage the next copy overwrites
    __syncthreads();
    const float4* pos = smem + (k % STAGES) * (2 * width);
    const float4* par = pos + width;
    const int col0 = col_ids[start + k] * width;
    // the live columns: valid atoms of the column groups not below this
    // warp's row group whose boxes come near its box, each near the box itself
    int n_live = 0;
    const float4 point = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g = 0; g < groups; ++g) {
      const int cg = col0 / GROUP + g;
      if (cg < rg || !near(rbc, rbh, boxes[2 * cg], boxes[2 * cg + 1], f)) continue;  // warp-uniform
      const int a = g * GROUP + lane;
      const bool live = par[a].w > 0.0f && near(rbc, rbh, pos[a], point, f);
      const unsigned m = __ballot_sync(FULL, live);
      if (live) cidx[n_live + __popc(m & ((1u << lane) - 1u))] = a;
      n_live += __popc(m);
    }
    __syncwarp();
    for (int base = 0; base < n_live; base += GROUP) {
      float4 col;
      chunk<MODE, POLY>(pos, par, cidx + base, n_live - base, col0, lane, i, rp, rq, f, s, rsum, col);
      if (base + lane < n_live) {
        const int j = col0 + cidx[base + lane];
        if (MODE == DP) fixed_point::add_checked(acc + j, col.x, flag);
        fixed_point::add_checked(acc + n_pad + j, col.y, flag);
        fixed_point::add_checked(acc + 2 * n_pad + j, col.z, flag);
        fixed_point::add_checked(acc + 3 * n_pad + j, col.w, flag);
      }
    }
    __syncwarp();  // every lane is done with cidx before the next tile's compaction
  }
  if (MODE != F) fixed_point::add_checked(acc + i, rsum.x, flag);
  fixed_point::add_checked(acc + n_pad + i, rsum.y, flag);
  fixed_point::add_checked(acc + 2 * n_pad + i, rsum.z, flag);
  fixed_point::add_checked(acc + 3 * n_pad + i, rsum.w, flag);
}

struct Launch {
  const float4* atoms;
  const int *row_start, *row_count, *col_ids;
  const float* scal;
  float4* out;
  unsigned long long* acc;
  float4* boxes;
  int n_blocks, cb;
  Series s;
  cudaStream_t stream;
};

template <int MODE>
int launch_sym(const Launch& a) {
  // above 48 KB a kernel needs an opt-in; MAX_CB keeps it at or below 40 KB
  const size_t smem = sizeof(float4) * (2 * BLOCK * a.cb + GROUPS * BLOCK);
  sym_kernel<MODE><<<a.n_blocks, SYM_THREADS, smem, a.stream>>>(a.atoms, a.row_start, a.row_count, a.col_ids, a.scal,
                                                                a.out, a.cb, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool POLY>
int launch_tri(const Launch& a) {
  const int n_pad = a.n_blocks * BLOCK;
  const int n_groups = n_pad / GROUP;
  group_boxes<<<(n_groups * 32 + 255) / 256, 256, 0, a.stream>>>(a.atoms, a.scal, a.boxes, n_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(sizeof(float4) * STAGES * 2 + sizeof(int) * WARPS) * BLOCK * a.cb;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(tri_kernel<MODE, POLY>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tri_kernel<MODE, POLY><<<dim3(a.n_blocks, SPLITS), THREADS, bytes, a.stream>>>(
      a.atoms, a.boxes, a.row_start, a.row_count, a.col_ids, a.scal, a.acc, n_pad, a.cb, a.s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_point::launch_store_checked(a.out, a.acc, n_pad, a.stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the sweep over n_blocks row blocks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_blocks,) i32, col_ids i32,
// scal (5,) f32, out (Npad, 4) f32; triangular only: acc (4 Npad + 1,) i64
// set to zero, boxes (Npad / 32 * 8,) f32 scratch. cb is the column
// super-block width in 128-atom blocks (1..8). mode: 0 UF, 1 F, 2 DP. h and
// hp are host arrays of 13 floats for the poly form, or both null for the
// exact form. Built forms: triangular DP, UF, UF-poly and F; symmetric DP
// and F. Any other returns cudaErrorInvalidValue and launches nothing; else
// the first CUDA error, or 0.
extern "C" int nb_tiles_launch(const void* atoms, const void* row_start, const void* row_count, const void* col_ids,
                               const void* scal, void* out, void* acc, void* boxes, int n_blocks, int cb, int mode,
                               int triangular, const float* h, const float* hp, void* stream) {
  const bool poly = h != nullptr;
  if (cb < 1 || cb > MAX_CB || (poly && hp == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Series s = {};
  if (poly) {
    for (int k = 0; k < NCOEF; ++k) {
      s.h[k] = h[k];
      s.hp[k] = hp[k];
    }
  }
  const Launch a{static_cast<const float4*>(atoms),
                 static_cast<const int*>(row_start),
                 static_cast<const int*>(row_count),
                 static_cast<const int*>(col_ids),
                 static_cast<const float*>(scal),
                 static_cast<float4*>(out),
                 static_cast<unsigned long long*>(acc),
                 static_cast<float4*>(boxes),
                 n_blocks,
                 cb,
                 s,
                 static_cast<cudaStream_t>(stream)};
  if (triangular) {
    if (mode == DP && !poly) return launch_tri<DP, false>(a);
    if (mode == UF) return poly ? launch_tri<UF, true>(a) : launch_tri<UF, false>(a);
    if (mode == F && !poly) return launch_tri<F, false>(a);
  } else if (!poly) {
    if (mode == DP) return launch_sym<DP>(a);
    if (mode == F) return launch_sym<F>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
