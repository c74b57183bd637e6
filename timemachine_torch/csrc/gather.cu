// Gather pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_gather_kernel` of
// timemachine_tpu/ops/pallas/gather_kernel.py (the `kernel="gather"`
// configuration), in its two modes: forces (every MD step) and forces +
// energy (stateless energy/force, the barostat's trial energies). Plain
// PyTorch version: gather_sweep_plain in timemachine_torch/ops/gather_kernel.py.
//
// What it computes, per row atom i of 32-atom row chunk r: the pair
// function of pair_math.cuh summed over the sorted slots nbr[r, 0:counts[r]],
// with minimum image. The lists are FULL (every pair listed from both of its
// atoms, the self pair and padding slots included and removed by the gate and
// by their q = eps = 0 rows), so a row's sums are complete on their own.
// Output per atom: [u_i, dU/dx_i], u_i half of atom i's pair energies.
//
// What bounds it on the card: arithmetic. At solvated DHFR (23,558 atoms,
// 737 row chunks) the lists at cutoff + skin hold about 2,700 slots per row
// chunk, 64M pair slots a sweep, each one rsqrt and about 45 FP32
// instructions (two 11-term Horner chains), against 32 bytes of column atom
// per slot gathered from a 754 KB atom array that stays in L2.
//
// What the design does about it:
// * the TPU kernel reads an XLA-gathered (rows * 8, max_nbrs) column array,
//   about 120 MB a step at DHFR, because it cannot gather; here each block
//   reads its row's indices and gathers the atom rows itself, straight into
//   shared memory, and loops to counts[r], not to max_nbrs;
// * one block of 4 warps per row chunk; lane l owns row atom l in registers,
//   warp w sweeps 32 of each staged 128-slot run, so every shared-memory read
//   is a broadcast and the inner loop has no shuffles;
// * the next run's indices and atoms are fetched into registers while the
//   current one is swept;
// * no atomics: the 4 warps' partial sums are added in a fixed order, so two
//   launches are bitwise equal.

#include <cuda_runtime.h>

#include "pair_math.cuh"

using namespace pair_math;

namespace {

constexpr int ROW = 32;   // atoms per row chunk
constexpr int RUN = 128;  // list slots staged at once
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS_PER_WARP = RUN / WARPS;

template <int MODE>
__global__ void __launch_bounds__(THREADS) gather_kernel(
    const float4* __restrict__ atoms,  // (Npad, 8) as 2 float4 per atom
    const int* __restrict__ counts,    // (nR,)
    const int* __restrict__ nbr,       // (nR, max_nbrs) sorted slots
    const float* __restrict__ scal,    // [box_x, box_y, box_z, cutoff]
    float4* __restrict__ out,          // (Npad) [u, dU/dx, dU/dy, dU/dz]
    int max_nbrs, const Series s) {
  __shared__ float4 tile[2 * RUN];
  __shared__ float4 part[WARPS][ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const int i = row * ROW + lane;

  const float bx = scal[0], by = scal[1], bz = scal[2], cutoff = scal[3];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float cut2 = cutoff * cutoff;

  const float4 ra = atoms[2 * i];      // x y z w
  const float4 rb = atoms[2 * i + 1];  // q sigma/2 2sqrt(eps) 0

  float u = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int count = min(counts[row], max_nbrs);
  const int* list = nbr + static_cast<size_t>(row) * max_nbrs;

  // thread t stages slot base + t of the list
  float4 next0 = make_float4(0.f, 0.f, 0.f, 0.f), next1 = next0;
  if (tid < count) {
    const int j = list[tid];
    next0 = atoms[2 * j];
    next1 = atoms[2 * j + 1];
  }
  for (int base = 0; base < count; base += RUN) {
    __syncthreads();  // every warp is done with the previous run
    tile[2 * tid] = next0;
    tile[2 * tid + 1] = next1;
    __syncthreads();
    const int k = base + RUN + tid;
    if (k < count) {
      const int j = list[k];
      next0 = atoms[2 * j];
      next1 = atoms[2 * j + 1];
    }
    const int first = warp * SLOTS_PER_WARP;
    const int last = min(first + SLOTS_PER_WARP, count - base);
#pragma unroll 4
    for (int jj = first; jj < last; ++jj) {
      const float4 ca = tile[2 * jj];
      const float4 cb = tile[2 * jj + 1];
      float dx = ra.x - ca.x;
      float dy = ra.y - ca.y;
      float dz = ra.z - ca.z;
      dx -= bx * rintf(dx * ibx);
      dy -= by * rintf(dy * iby);
      dz -= bz * rintf(dz * ibz);
      float de_r, e;
      pair_terms<MODE>(dx, dy, dz, ra.w - ca.w, rb.x * cb.x, rb.y + cb.y, rb.z * cb.z, cut2, true, s, de_r, e);
      gx = fmaf(de_r, dx, gx);
      gy = fmaf(de_r, dy, gy);
      gz = fmaf(de_r, dz, gz);
      if (MODE == FORCE_ENERGY) u += e;
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
// atoms (Npad, 8) f32, counts (n_rows,) i32, nbr (n_rows, max_nbrs) i32,
// scal (4,) f32, out (Npad, 4) f32. h and p are host arrays of 11 floats.
// mode: 0 forces, 1 forces + energy. Returns cudaGetLastError().
extern "C" int gather_sweep_launch(const void* atoms, const void* counts, const void* nbr, const void* scal, void* out,
                                   int n_rows, int max_nbrs, int mode, const float* h, const float* p, void* stream) {
  const Series s = make_series(h, p);
  const dim3 grid(n_rows), block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(atoms);
  const int* c = static_cast<const int*>(counts);
  const int* nb = static_cast<const int*>(nbr);
  const float* sc = static_cast<const float*>(scal);
  float4* o = static_cast<float4*>(out);
  switch (mode) {
    case FORCE:
      gather_kernel<FORCE><<<grid, block, 0, st>>>(a, c, nb, sc, o, max_nbrs, s);
      break;
    case FORCE_ENERGY:
      gather_kernel<FORCE_ENERGY><<<grid, block, 0, st>>>(a, c, nb, sc, o, max_nbrs, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
