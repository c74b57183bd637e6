// Nonbonded block-tile sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_nb_tile_kernel` (and `_nb_tile_kernel_vmem`, the
// same function with VMEM-resident arrays) of
// timemachine_tpu/ops/pallas/nonbonded_kernel.py, in all of its modes:
//   UF  energy + dU/dx          (the kernel="v1" energy/force path)
//   F   dU/dx only              (the kernel="v1" MD provider)
//   DP  dU/dp                   (the backward pass of the condensed-phase
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
//   UF  [u_i, dU/dx_i]   with u_i half of atom i's pair energies
//   F   [0,   dU/dx_i]
//   DP  [dU/dq_i, dU/d(sig/2)_i, dU/d sqrt(eps)_i, dU/dw_i]
//
// What bounds it on the card: arithmetic. Each pair slot costs one rsqrt,
// in the exact form also one exp, one cos, one sqrt and three IEEE
// divisions (the minimum image divides by the box, as the TPU kernel does),
// about 90 FP32 instructions in all; it reads 32 bytes per column atom from
// shared memory, broadcast to a whole warp. Solvated DHFR at cb = 2 gives
// 186 row blocks: fewer than two blocks per SM.
//
// What the design does about it:
// * one block of 512 threads per 128-atom row block: thread t owns row atom
//   t % 128 and a quarter of every staged column super-block, so the grid
//   has 4x more warps than a thread-per-row design (the low-occupancy
//   risk above), and every shared-memory read is a warp-wide broadcast;
// * each listed column super-block (4 KB per 128 atoms) is staged in
//   dynamic shared memory;
// * no atomics: each thread sums its quarter in a fixed order and the four
//   quarters are added in a fixed order at the end, so two launches are
//   bitwise equal;
// * masked pairs take r2 := 1 before the rsqrt and every output term is a
//   select on the mask, so no 0 * inf from sig = 0, eps = 0 or padding
//   reaches a sum; the self pair is masked by global index, not by r2.
//   Build without --use_fast_math;
// * box, beta and cutoff are read from a 5-float device array, so the host
//   never syncs.
// Newton-triangular lists, Hopper's asynchronous copies and a cheaper switch
// are left to measured later work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;  // atoms per row block
constexpr int GROUPS = 4;   // threads per row atom, each over a quarter of the columns
constexpr int THREADS = BLOCK * GROUPS;
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

__device__ __forceinline__ float min_image(float d, float box) { return d - box * floorf(d / box + 0.5f); }

template <int MODE, bool POLY>
__global__ void __launch_bounds__(THREADS) nb_tiles_kernel(
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
    for (int t = threadIdx.x; t < 2 * width; t += THREADS) tile[t] = src[t];
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

      const float r2m = mask ? r2 : 1.0f;
      const float inv_r = rsqrtf(r2m);
      const float rr = r2m * inv_r;
      const float inv_r2 = inv_r * inv_r;

      const float qq = rp.x * cp.x;
      const float sig = rp.y + cp.y;
      const float eps = rp.z * cp.z;
      const float s2 = sig * sig * inv_r2;
      const float t6 = s2 * s2 * s2;
      const float t12 = t6 * t6;
      const float eps4 = 4.0f * eps;
      const float e_lj = eps4 * (t12 - t6);
      const float dlj_r = eps4 * inv_r2 * (6.0f * t6 - 12.0f * t12);

      float e_es, des_r, s_r_sw;
      if (POLY) {
        const float t2 = 2.0f * (2.0f * (rr * INV_C) - 1.0f);
        const float h = clenshaw(s.h, t2);
        const float hp = clenshaw(s.hp, t2);
        s_r_sw = h * inv_r;
        e_es = qq * s_r_sw;
        des_r = qq * inv_r2 * (hp * INV_C - h * inv_r);
      } else {
        const float v = r2m * INV_C2;
        const float v2 = v * v;
        const float u8 = v2 * v2;
        const float cosu = cosf((0.5f * PI) * u8);
        const float cos2 = cosu * cosu;
        const float sinu = sqrtf(fmaxf(1.0f - cos2, 0.0f));
        const float sw = cos2 * cosu;
        const float dsw_dr = -12.0f * PI * u8 * inv_r * cos2 * sinu;
        const float x = beta * rr;
        const float gauss = expf(-x * x);
        const float tt = 1.0f / (1.0f + 0.3275911f * x);
        const float erfc_bar =
            gauss * tt *
            (0.254829592f + tt * (-0.284496736f + tt * (1.421413741f + tt * (-1.453152027f + tt * 1.061405429f))));
        const float s_r = erfc_bar * inv_r;
        const float ds_dr = -beta * TWO_OVER_SQRT_PI * gauss * inv_r - erfc_bar * inv_r2;
        e_es = qq * s_r * sw;
        des_r = qq * (ds_dr * sw + s_r * dsw_dr) * inv_r;
        s_r_sw = s_r * sw;
      }
      const float de_r = mask ? dlj_r + des_r : 0.0f;

      if (MODE == DP) {
        const float sig_safe = sig > 0.0f ? sig : 1.0f;
        a0 += mask ? cp.x * s_r_sw : 0.0f;
        a1 += (mask && eps != 0.0f) ? eps4 * (12.0f * t12 - 6.0f * t6) / sig_safe : 0.0f;
        a2 += mask ? cp.z * (4.0f * (t12 - t6)) : 0.0f;
        a3 += de_r * dw;
      } else {
        if (MODE == UF) a0 += mask ? e_lj + e_es : 0.0f;
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
    if (MODE == UF) acc.x *= 0.5f;  // each pair's energy was counted from both of its atoms
    out[i] = acc;
  }
}

template <int MODE, bool POLY>
int launch(const dim3 grid, const size_t smem, cudaStream_t st, const float4* a, const int* rs, const int* rc,
           const int* ci, const float* sc, float4* o, int cb, const Series& s) {
  // above 48 KB a kernel needs an opt-in; MAX_CB keeps it at or below 40 KB
  nb_tiles_kernel<MODE, POLY><<<grid, THREADS, smem, st>>>(a, rs, rc, ci, sc, o, cb, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the sweep over n_blocks row blocks on `stream`. Device pointers:
// atoms (Npad, 8) f32, row_start/row_count (n_blocks,) i32, col_ids i32,
// scal (5,) f32, out (Npad, 4) f32. cb is the column super-block width in
// 128-atom blocks (1..8). mode: 0 UF, 1 F, 2 DP. h and hp are host arrays of
// 13 floats for the poly form, or both null for the exact form; DP takes
// only the exact form. Returns cudaGetLastError().
extern "C" int nb_tiles_launch(const void* atoms, const void* row_start, const void* row_count, const void* col_ids,
                               const void* scal, void* out, int n_blocks, int cb, int mode, const float* h,
                               const float* hp, void* stream) {
  const bool poly = h != nullptr;
  if (cb < 1 || cb > MAX_CB || (poly && hp == nullptr) || (poly && mode == DP)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Series s = {};
  if (poly) {
    for (int k = 0; k < NCOEF; ++k) {
      s.h[k] = h[k];
      s.hp[k] = hp[k];
    }
  }
  const dim3 grid(n_blocks);
  const size_t smem = sizeof(float4) * (2 * BLOCK * cb + GROUPS * BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* ci = static_cast<const int*>(col_ids);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  switch (mode) {
    case UF:
      return poly ? launch<UF, true>(grid, smem, st, a, rs, rc, ci, sc, o, cb, s)
                  : launch<UF, false>(grid, smem, st, a, rs, rc, ci, sc, o, cb, s);
    case F:
      return poly ? launch<F, true>(grid, smem, st, a, rs, rc, ci, sc, o, cb, s)
                  : launch<F, false>(grid, smem, st, a, rs, rc, ci, sc, o, cb, s);
    case DP:
      return launch<DP, false>(grid, smem, st, a, rs, rc, ci, sc, o, cb, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
