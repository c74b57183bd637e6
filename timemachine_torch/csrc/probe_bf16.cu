// bf16 vs f32 rate probe of the distance-and-gate sequence, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` of scripts/probe_bf16.py (:41, pallas_call
// :71): per element, in the working type (f32 or bf16), ITERS times
//   sh = (1 + t * 1e-3) rounded to the working type      (computed in f32)
//   dx = a - b sh,  dy = a sh - b,  dz = a - b
//   r2 = (dx dx + dy dy) + dz dz
//   acc = acc + (f32(r2) < cut2 ? 1 : 0)
// and out = f32(acc), the per-slot sequence a bf16 distance prefilter would
// run. Plain PyTorch version: bf16_rate_plain in
// timemachine_torch/probes/bf16_rate.py.
//
// What bounds it on the card: the vector pipes (ITERS * 10 operations per
// element against 12 bytes), by design. The question it answers is the
// rate ratio of packed bf16 (two elements per instruction) to f32.
//
// Every operation rounds to the working type by an explicit intrinsic
// (__fmul_rn / __fsub_rn / __fadd_rn, __hmul2_rn / __hsub2_rn /
// __hadd2_rn), so no multiply-add contracts into an FMA and the plain
// version matches bit for bit. Two designs:
//
// - The first design (gate_f32, gate_bf16), the yardstick: one thread per
//   element in f32, per pair of elements in bf16 (__nv_bfloat162), the
//   shift recomputed by every thread at every iteration, and the compare in
//   f32 as in the TPU script: the bf16 kernel unpacks r2 to two floats,
//   compares and selects twice and repacks.
// - The redesign (f32_gate_wave, bf16_gate_wave):
//   * the bf16 gate is packed: for T the smallest bf16 value >= f32(cut2)
//     (the wrapper computes its bits), f32(r2) < cut2 <=> r2 < T for every
//     bf16 r2, NaN false on both sides, so one __hlt2 gives the hit as a
//     bf16x2 of 1.0 and 0.0 and one __hadd2_rn counts it;
//   * the shift is read from a per-block shared table, filled CHUNK
//     iterations at a time into one of two buffers (one barrier per chunk:
//     the buffer a chunk fills was last read two chunks before);
//   * each thread takes ELEMS elements (f32) or ELEMS element pairs (bf16),
//     loaded as 16-byte vectors, and the iteration loop is unrolled by 4, so
//     independent chains hide the pipes' latency; dz and dz^2 are computed
//     once;
//   * the grid is one wave (SMs x resident blocks, asked once per device)
//     or fewer blocks where the elements need fewer, striding over the
//     elements; a partial last group is loaded and stored element by
//     element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float shift(int t) { return __fadd_rn(1.0f, __fmul_rn(static_cast<float>(t), 1e-3f)); }

__global__ void __launch_bounds__(256) gate_f32(const float* __restrict__ a, const float* __restrict__ b,
                                                float* __restrict__ out, int n, int iters, float cut2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float av = a[i], bv = b[i];
  float acc = 0.0f;
  for (int t = 0; t < iters; ++t) {
    const float sh = shift(t);
    const float dx = __fsub_rn(av, __fmul_rn(bv, sh));
    const float dy = __fsub_rn(__fmul_rn(av, sh), bv);
    const float dz = __fsub_rn(av, bv);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    acc = __fadd_rn(acc, r2 < cut2 ? 1.0f : 0.0f);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(256) gate_bf16(const float2* __restrict__ a, const float2* __restrict__ b,
                                                 float2* __restrict__ out, int n2, int iters, float cut2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 av = __float22bfloat162_rn(a[i]);
  const __nv_bfloat162 bv = __float22bfloat162_rn(b[i]);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f), zero = __float2bfloat16_rn(0.0f);
  __nv_bfloat162 acc = __bfloat162bfloat162(zero);
  for (int t = 0; t < iters; ++t) {
    const __nv_bfloat162 sh = __bfloat162bfloat162(__float2bfloat16_rn(shift(t)));
    const __nv_bfloat162 dx = __hsub2_rn(av, __hmul2_rn(bv, sh));
    const __nv_bfloat162 dy = __hsub2_rn(__hmul2_rn(av, sh), bv);
    const __nv_bfloat162 dz = __hsub2_rn(av, bv);
    const __nv_bfloat162 r2 = __hadd2_rn(__hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)), __hmul2_rn(dz, dz));
    const float2 rf = __bfloat1622float2(r2);
    acc = __hadd2_rn(acc, __halves2bfloat162(rf.x < cut2 ? one : zero, rf.y < cut2 ? one : zero));
  }
  out[i] = __bfloat1622float2(acc);
}

// -- the redesign ------------------------------------------------------------------

constexpr int ELEMS = 2;      // f32 elements, or bf16 element pairs, per thread
constexpr int THREADS = 128;  // per block
constexpr int CHUNK = 256;    // shift-table iterations per barrier

// v[0..V) = p[base..base+V), as 16-byte (or 8-byte) vectors where the group
// is whole, element by element (0 past n) where it is the last, partial one.
template <int V>
__device__ __forceinline__ void load_group(const float* __restrict__ p, int base, int n, float (&v)[V]) {
  static_assert(V % 4 == 0 || V == 2, "groups of 2 or of a multiple of 4 floats");
  if (base + V <= n) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p + base)[k];
        v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
      }
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p + base);
      v[0] = q.x, v[1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = base + k < n ? p[base + k] : 0.0f;
  }
}

template <int V>
__device__ __forceinline__ void store_group(float* __restrict__ p, int base, int n, const float (&v)[V]) {
  if (base + V <= n) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        reinterpret_cast<float4*>(p + base)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else {
      *reinterpret_cast<float2*>(p + base) = make_float2(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (base + k < n) p[base + k] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS) f32_gate_wave(const float* __restrict__ a, const float* __restrict__ b,
                                                         float* __restrict__ out, int n, int iters, float cut2) {
  constexpr int V = ELEMS;
  __shared__ __align__(16) float table[2][CHUNK];
  const int groups = (n + V - 1) / V;
  int chunk = 0;  // chunks filled by this block, across its groups
  for (int g0 = blockIdx.x * THREADS; g0 < groups; g0 += gridDim.x * THREADS) {  // uniform in the block
    const int g = g0 + threadIdx.x;
    const bool live = g < groups;
    float av[V] = {}, bv[V] = {}, dz2[V], acc[V];
    if (live) {
      load_group(a, g * V, n, av);
      load_group(b, g * V, n, bv);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float dz = __fsub_rn(av[e], bv[e]);
      dz2[e] = __fmul_rn(dz, dz);
      acc[e] = 0.0f;
    }
    for (int t0 = 0; t0 < iters; t0 += CHUNK, ++chunk) {
      float* tab = table[chunk & 1];
      const int len = min(CHUNK, iters - t0);
      for (int j = threadIdx.x; j < len; j += THREADS) tab[j] = shift(t0 + j);
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int t = 0; t < len; ++t) {
          const float sh = tab[t];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float dx = __fsub_rn(av[e], __fmul_rn(bv[e], sh));
            const float dy = __fsub_rn(__fmul_rn(av[e], sh), bv[e]);
            const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), dz2[e]);
            acc[e] = __fadd_rn(acc[e], r2 < cut2 ? 1.0f : 0.0f);
          }
        }
      }
    }
    if (live) store_group(out, g * V, n, acc);
  }
}

__global__ void __launch_bounds__(THREADS) bf16_gate_wave(const float* __restrict__ a, const float* __restrict__ b,
                                                          float* __restrict__ out, int n, int iters,
                                                          unsigned short threshold_bits) {
  constexpr int V = 2 * ELEMS;
  __shared__ __align__(16) __nv_bfloat162 table[2][CHUNK];
  const __nv_bfloat162 thr = __bfloat162bfloat162(__ushort_as_bfloat16(threshold_bits));
  const int groups = (n + V - 1) / V;  // n is even: a group never splits a pair
  int chunk = 0;
  for (int g0 = blockIdx.x * THREADS; g0 < groups; g0 += gridDim.x * THREADS) {  // uniform in the block
    const int g = g0 + threadIdx.x;
    const bool live = g < groups;
    float fa[V] = {}, fb[V] = {}, fo[V];
    if (live) {
      load_group(a, g * V, n, fa);
      load_group(b, g * V, n, fb);
    }
    __nv_bfloat162 av[ELEMS], bv[ELEMS], dz2[ELEMS], acc[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      av[e] = __floats2bfloat162_rn(fa[2 * e], fa[2 * e + 1]);
      bv[e] = __floats2bfloat162_rn(fb[2 * e], fb[2 * e + 1]);
      const __nv_bfloat162 dz = __hsub2_rn(av[e], bv[e]);
      dz2[e] = __hmul2_rn(dz, dz);
      acc[e] = __bfloat162bfloat162(__float2bfloat16_rn(0.0f));
    }
    for (int t0 = 0; t0 < iters; t0 += CHUNK, ++chunk) {
      __nv_bfloat162* tab = table[chunk & 1];
      const int len = min(CHUNK, iters - t0);
      for (int j = threadIdx.x; j < len; j += THREADS) tab[j] = __bfloat162bfloat162(__float2bfloat16_rn(shift(t0 + j)));
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int t = 0; t < len; ++t) {
          const __nv_bfloat162 sh = tab[t];
#pragma unroll
          for (int e = 0; e < ELEMS; ++e) {
            const __nv_bfloat162 dx = __hsub2_rn(av[e], __hmul2_rn(bv[e], sh));
            const __nv_bfloat162 dy = __hsub2_rn(__hmul2_rn(av[e], sh), bv[e]);
            const __nv_bfloat162 r2 = __hadd2_rn(__hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)), dz2[e]);
            acc[e] = __hadd2_rn(acc[e], __hlt2(r2, thr));
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const float2 o = __bfloat1622float2(acc[e]);
        fo[2 * e] = o.x, fo[2 * e + 1] = o.y;
      }
      store_group(out, g * V, n, fo);
    }
  }
}

// Blocks of one wave of `kernel` on the current device: SMs x resident
// blocks of THREADS, asked once per device (0 if the query fails).
template <typename Kernel>
int wave_blocks(Kernel kernel) {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

}  // namespace

// Launch the probe over n > 0 elements on `stream`: a, b, out (n,) f32
// device pointers, 16-byte aligned for the redesign; bf16 != 0 takes the
// packed bf16 kernel (n even), first_design != 0 the first design. The f32
// kernels and the first design gate on cut2, the redesigned bf16 kernel on
// the bf16 value whose bits are threshold_bits (the smallest bf16 >= cut2).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what the
// kernels do not take.
extern "C" int gate_rate_launch(const void* a, const void* b, void* out, int n, int iters, float cut2,
                                int threshold_bits, int bf16, int first_design, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || iters < 0 || (bf16 && n % 2)) return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  if (first_design) {
    if (bf16) {
      const int n2 = n / 2;
      gate_bf16<<<(n2 + 255) / 256, 256, 0, st>>>(reinterpret_cast<const float2*>(fa),
                                                  reinterpret_cast<const float2*>(fb),
                                                  reinterpret_cast<float2*>(fo), n2, iters, cut2);
    } else {
      gate_f32<<<(n + 255) / 256, 256, 0, st>>>(fa, fb, fo, n, iters, cut2);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) | reinterpret_cast<size_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = bf16 ? 2 * ELEMS : ELEMS;
  const int needed = ((n + per_thread - 1) / per_thread + THREADS - 1) / THREADS;
  const int wave = bf16 ? wave_blocks(bf16_gate_wave) : wave_blocks(f32_gate_wave);
  if (wave <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = needed < wave ? needed : wave;
  if (bf16)
    bf16_gate_wave<<<grid, THREADS, 0, st>>>(fa, fb, fo, n, iters, static_cast<unsigned short>(threshold_bits));
  else
    f32_gate_wave<<<grid, THREADS, 0, st>>>(fa, fb, fo, n, iters, cut2);
  return static_cast<int>(cudaGetLastError());
}
