// The live-column ring of the Newton-triangular quadscan and dotscan sweeps
// (quadscan.cu, dotscan.cu). Each warp stages 32 column atoms at a time by
// cp.async (`stage`, each lane its own atom), tests each against its row
// chunk's box, and appends the live ones, by ballot and prefix in lane
// order, to a ring of RING shared-memory slots; the warp sweeps the ring in
// chunks of 32 as they fill, and pads its last chunk with dead slots. A
// slot holds the column's position as the pair function subtracts it, its
// parameters with a gate index in the fourth float (a row atom pairs with
// it only where the row's sorted index is below the gate: the column's own
// index on the diagonal tile, NO_GATE elsewhere, DEAD for padding), and
// its sorted index for the reaction.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace live_columns {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 4;            // cp.async ring of 32-atom stages per warp
constexpr int RING = 64;             // a chunk being swept and the next one filling
constexpr float CULL_SLACK = 1e-3f;  // nm added to the cutoff by the culls, as nonbonded_kernel.CULL_SLACK
constexpr float FAR = 1e4f;          // nm: where a dead slot sits
constexpr int NO_GATE = INT_MAX;
constexpr int DEAD = -1;

// one warp's shared memory
struct WarpSmem {
  float4 stage[STAGES][2 * 32];  // 32 column atoms per stage, as in the atom rows
  float4 pos[RING];              // live columns: x y z w as the pair function subtracts them
  float4 par[RING];              // q sigma/2 2sqrt(eps), gate index (int bits)
  int idx[RING];                 // sorted index of the column atom
};

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

// Append this lane's column, if live, at slot head + its rank among the
// live lanes: position p, parameters q (q.w is replaced by the gate index),
// sorted index j. Returns how many lanes appended (warp-uniform).
__device__ __forceinline__ int push(WarpSmem& sm, int head, int lane, bool live, const float4& p, const float4& q,
                                    int gate, int j) {
  const unsigned m = __ballot_sync(FULL, live);
  if (live) {
    const int slot = (head + __popc(m & ((1u << lane) - 1u))) & (RING - 1);
    sm.pos[slot] = p;
    sm.par[slot] = make_float4(q.x, q.y, q.z, __int_as_float(gate));
    sm.idx[slot] = j;
  }
  return __popc(m);
}

// Slots tail + n .. tail + 31 of the last chunk (n live) become dead: far
// away, no parameters, gated off for every row atom.
__device__ __forceinline__ void fill_dead(WarpSmem& sm, int tail, int n, int lane) {
  if (lane >= n) {
    const int slot = (tail + lane) & (RING - 1);
    sm.pos[slot] = make_float4(FAR, FAR, FAR, 0.0f);
    sm.par[slot] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(DEAD));
  }
  __syncwarp();
}

// The slot lane l pairs its two row atoms with at step k (0 .. 15) of the
// chunk at base: half-warp h takes the chunk's slots 16 h .. 16 h + 15 and
// lane l slot 16 h + (l % 16 + k) % 16, so the column sum it carries, handed
// on from lane l + 1 of its half-warp at each step, is slot l's after 16
// steps. The 8 lanes of a quarter-warp read 8 consecutive slots: no bank
// conflict.
__device__ __forceinline__ int slot_at(int base, int lane, int k) {
  return (base + (lane & 16) + (((lane & 15) + k) & 15)) & (RING - 1);
}

// The lane a carried column sum comes from at each step
__device__ __forceinline__ int next_lane(int lane) { return (lane & 16) | ((lane + 1) & 15); }

}  // namespace live_columns
