// MoE routing masks for Hopper (sm_90a), plain CUDA C++ behind a C interface:
// every token group's capacity slots, dispatch and combine tensors and kept
// counts in one launch, and the gate's gradient in a second entry point.
//
// Replaces no TPU kernel.  The reference builds these masks in jnp
// (`_top_k_dispatch` in src/repro/models/moe.py), a loop over the k choices
// that XLA fuses into a few passes.  Run eagerly, the same loop is some 650
// operations a layer call, each choice's (g, E, C) float32 one-hot written
// and read several times over, and its backward keeps the k one-hots.  This
// kernel computes the loop's result bit for bit.  For G groups of g tokens,
// each token's k experts top_idx (G, g, k) int64 and their renormalised
// gates top_vals (G, g, k) float32:
//   rank(n, j)   the choice's place among the group's choices of the same
//                expert in (j, n) order: every token's first choice before
//                any second choice, tokens in order within a choice; a
//                dropped choice counts towards the later ranks, a repeated
//                expert of one token is two choices
//   slot(n, j)   rank(n, j) if it is below the capacity C, else -1
//   dispatch[n, e, c] = 1 and combine[n, e, c] = top_vals[n, j] rounded once
//   to the output type where e = top_idx[n, j] and c = slot(n, j) >= 0;
//   every other element 0 (each element has at most one such choice)
//   routed[n]    the number of token n's choices kept, in the output type
//   slots        (G, g, k) int32, saved for the backward
// An expert outside [0, E) is never kept and takes no rank, as in the loop.
// The backward (moe_dispatch_bwd) gives top_vals the gradient
// grad_combine[n, e, slot] in float32, 0 where the choice was dropped: the
// one nonzero term of the loop's sum.
//
// What bounds it on the H100: the bytes written.  At olmoe-1b-7b's training
// shapes (G 4, g 2,048, E 64, k 8, C 320, bfloat16) dispatch and combine are
// 335.5 MB each, 0.200 ms at 3.35 TB/s; everything else (top_idx and
// top_vals read, slots and routed written) is 1 MB.  What the design does:
//   - one block of 256 threads per (group, tile of 32 tokens), 256 blocks at
//     those shapes, all resident at once.  A block ranks its own tokens'
//     choices and writes their rows, so the kept counts need nothing from
//     another block and the whole result is one launch with no zero fill;
//   - ranking is a counting sort with no scan over device memory: the block
//     counts the group's choices by (expert, choice), all of them and those
//     of the tokens before its tile, from one coalesced walk of the group's
//     top_idx (128 KB, read from L2 by each of the group's blocks), a warp
//     match merging the lanes of one (expert, choice) into one shared-memory
//     atomic.  rank(n, j) is then the count of e at choices before j, plus
//     e's count at j before the tile, plus the tile's earlier tokens of e at
//     j (one __match_any_sync over the warp that holds the tile, a lane a
//     token);
//   - the tile's rows, tokens x E x C, are one contiguous span of each
//     output, written once with streaming 16-byte stores (8- or 4-byte ones
//     where C is not a multiple of the 16-byte vector), neighbouring threads
//     on neighbouring vectors; a vector's value comes from the token's k
//     choices held in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;  // tokens a block: one warp's lanes in the ranking

// The output's element type by its bits: a float32 rounded to it (round to
// nearest even, as torch's cast) and widened from it (exact).
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ Bits narrow(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float widen(Bits b) { return __uint_as_float(b); }
};
struct BF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ Bits narrow(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ float widen(Bits b) { return __uint_as_float(static_cast<uint32_t>(b) << 16); }
};

// V elements in one streaming store (st.global.cs) of 2 to 16 bytes.
template <int V, typename Bits>
__device__ __forceinline__ void store_stream(Bits* p, const Bits (&x)[V]) {
  constexpr int BYTES = V * static_cast<int>(sizeof(Bits));
  if constexpr (BYTES == 16) {
    uint4 u;
    memcpy(&u, x, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else if constexpr (BYTES == 8) {
    uint2 u;
    memcpy(&u, x, 8);
    __stcs(reinterpret_cast<uint2*>(p), u);
  } else if constexpr (BYTES == 4) {
    unsigned int u;
    memcpy(&u, x, 4);
    __stcs(reinterpret_cast<unsigned int*>(p), u);
  } else {
    static_assert(BYTES == 2, "2, 4, 8 or 16-byte vectors");
    unsigned short u;
    memcpy(&u, x, 2);
    __stcs(reinterpret_cast<unsigned short*>(p), u);
  }
}

// Dynamic shared memory, in 4-byte words: the (E, k) counts twice, then the
// tile's (TILE, k) kept experts, slots and gates.
__host__ __device__ __forceinline__ int smem_words(int E, int k) { return 2 * E * k + 3 * TILE * k; }

template <typename D, int V>
__global__ void __launch_bounds__(THREADS)
    dispatch_kernel(const int64_t* __restrict__ top_idx, const float* __restrict__ top_vals,
                    typename D::Bits* __restrict__ dispatch, typename D::Bits* __restrict__ combine,
                    typename D::Bits* __restrict__ routed, int32_t* __restrict__ slots, int g, int E, int k,
                    int C) {
  using Bits = typename D::Bits;
  extern __shared__ int smem[];
  int* total = smem;                  // (E, k): the group's choices of expert e at choice j
  int* base = total + E * k;          // (E, k): those before the tile, then the rank of the tile's first
  int* t_expert = base + E * k;       // (TILE, k): the expert of each kept choice of the tile, else -1
  int* t_slot = t_expert + TILE * k;  // (TILE, k): its slot, else -1
  float* t_val = reinterpret_cast<float*>(t_slot + TILE * k);  // (TILE, k): its gate

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int T = min(TILE, g - n0);
  const int64_t* idx = top_idx + static_cast<size_t>(grp) * g * k;

  for (int i = tid; i < 2 * E * k; i += THREADS) smem[i] = 0;
  __syncthreads();

  // 1. counts by (expert, choice) over the group, and over the tokens before the tile
  const int L = g * k, before = n0 * k;
  for (int i0 = 0; i0 < L; i0 += THREADS) {  // the same trip count in every warp
    const int i = i0 + tid;
    int key = -1;
    if (i < L) {
      const int64_t e = idx[i];
      if (e >= 0 && e < E) key = static_cast<int>(e) * k + i % k;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const unsigned early = peers & __ballot_sync(0xffffffffu, i < before);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&total[key], __popc(peers));
      if (early) atomicAdd(&base[key], __popc(early));
    }
  }
  __syncthreads();

  // 2. base(e, j) = e's choices at j' < j over the group + e's choices at j before the tile
  for (int e = tid; e < E; e += THREADS) {
    int run = 0;
    for (int j = 0; j < k; ++j) {
      const int t = total[e * k + j];
      base[e * k + j] += run;
      run += t;
    }
  }
  __syncthreads();

  // 3. the tile's ranks: a warp a choice j, lane t token n0 + t; the tile's
  //    earlier tokens with the same expert at j by one match over the warp
  const unsigned lower = (1u << lane) - 1u;
  for (int j = warp; j < k; j += WARPS) {
    const bool in = lane < T;
    const size_t at = (static_cast<size_t>(grp) * g + n0 + lane) * k + j;
    int key = -1;
    if (in) {
      const int64_t e = top_idx[at];
      if (e >= 0 && e < E) key = static_cast<int>(e);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    int slot = -1;
    if (key >= 0) {
      const int rank = base[key * k + j] + __popc(peers & lower);
      if (rank < C) slot = rank;
    }
    if (in) {
      t_expert[lane * k + j] = slot >= 0 ? key : -1;
      t_slot[lane * k + j] = slot;
      t_val[lane * k + j] = top_vals[at];
      slots[at] = slot;
    }
  }
  __syncthreads();

  // 4. routed: the tile's tokens' kept choices
  if (tid < T) {
    int kept = 0;
    for (int j = 0; j < k; ++j) kept += t_slot[tid * k + j] >= 0;
    routed[static_cast<size_t>(grp) * g + n0 + tid] = D::narrow(static_cast<float>(kept));
  }

  // 5. the tile's rows (T x E x C, contiguous), vector v = tid + THREADS * step:
  //    (token tt, expert e, vector cv of the row), advanced without a division
  const int CV = C / V;
  const size_t off = (static_cast<size_t>(grp) * g + n0) * E * C;
  Bits* const dp = dispatch + off;
  Bits* const cp = combine + off;
  const Bits one = D::narrow(1.0f);
  int row = tid / CV, cv = tid - row * CV;
  int tt = row / E, e = row - tt * E;
  const int drow = THREADS / CV, dcv = THREADS - drow * CV;
  const int dt = drow / E, de = drow - dt * E;
  while (tt < T) {
    Bits d[V], c[V];
#pragma unroll
    for (int q = 0; q < V; ++q) d[q] = c[q] = 0;
    for (int j = 0; j < k; ++j) {
      if (t_expert[tt * k + j] != e) continue;
      const int s = t_slot[tt * k + j] - cv * V;
      if (s < 0 || s >= V) continue;
      const Bits val = D::narrow(t_val[tt * k + j]);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (q == s) {
          d[q] = one;
          c[q] = val;
        }
      }
    }
    const size_t at = (static_cast<size_t>(tt) * E + e) * C + static_cast<size_t>(cv) * V;
    store_stream<V>(dp + at, d);
    store_stream<V>(cp + at, c);
    cv += dcv;
    int carry = 0;
    if (cv >= CV) {
      cv -= CV;
      carry = 1;
    }
    e += de + carry;  // below 2E: one wrap at most
    tt += dt;
    if (e >= E) {
      e -= E;
      ++tt;
    }
  }
}

// grad_vals[i] = grad_combine[grp, n, top_idx[i], slots[i]] widened to float32, 0 where slots[i] < 0;
// i = (grp * g + n) * k + j, grad_combine read through its strides (elements).
template <typename D>
__global__ void __launch_bounds__(THREADS)
    grad_kernel(const typename D::Bits* __restrict__ grad, const int64_t* __restrict__ top_idx,
                const int32_t* __restrict__ slots, float* __restrict__ out, long long n, int g, int k, long long s0,
                long long s1, long long s2, long long s3) {
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const int slot = slots[i];
    float v = 0.0f;
    if (slot >= 0) {
      const long long tok = i / k;
      const long long grp = tok / g, tn = tok - grp * g;
      v = D::widen(grad[grp * s0 + tn * s1 + top_idx[i] * s2 + slot * s3]);
    }
    out[i] = v;
  }
}

template <typename D, int V>
int launch_fwd(const void* top_idx, const void* top_vals, void* dispatch, void* combine, void* routed, void* slots,
               int G, int g, int E, int k, int C, cudaStream_t stream) {
  using Bits = typename D::Bits;
  const size_t smem = static_cast<size_t>(smem_words(E, k)) * 4;
  auto kernel = dispatch_kernel<D, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((g + TILE - 1) / TILE, G);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const int64_t*>(top_idx), static_cast<const float*>(top_vals),
                                          static_cast<Bits*>(dispatch), static_cast<Bits*>(combine),
                                          static_cast<Bits*>(routed), static_cast<int32_t*>(slots), g, E, k, C);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector of at most 16 bytes whose element count divides C, so that no vector crosses a row.
template <typename D>
int launch_fwd_vec(const void* top_idx, const void* top_vals, void* dispatch, void* combine, void* routed,
                   void* slots, int G, int g, int E, int k, int C, cudaStream_t stream) {
  constexpr int W = 16 / static_cast<int>(sizeof(typename D::Bits));
  if (C % W == 0) return launch_fwd<D, W>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C, stream);
  if (C % (W / 2) == 0)
    return launch_fwd<D, W / 2>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C, stream);
  if (C % (W / 4) == 0)
    return launch_fwd<D, W / 4>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C, stream);
  if constexpr (W == 8) return launch_fwd<D, 1>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C,
                                                stream);
  return static_cast<int>(cudaErrorInvalidValue);  // unreachable: W / 4 is 1 for float32
}

}  // namespace

// top_idx (G, g, k) int64 and top_vals (G, g, k) float32, contiguous; dispatch
// and combine (G, g, E, C), routed (G, g) in `dtype` (0 float32, 1 bfloat16)
// and slots (G, g, k) int32, contiguous, written whole.  The wrapper
// (kernels/moe_dispatch.py) checks the shapes and the shared memory
// (smem_words(E, k) words of 4 bytes, at most 227 KB).  Returns a cudaError_t
// (0 = launched).
extern "C" int moe_dispatch_fwd(const void* top_idx, const void* top_vals, void* dispatch, void* combine,
                                void* routed, void* slots, int G, int g, int E, int k, int C, int dtype,
                                void* stream) {
  if (G < 1 || g < 1 || E < 1 || k < 1 || C < 1 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd_vec<F32>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C, st);
    case 1: return launch_fwd_vec<BF16>(top_idx, top_vals, dispatch, combine, routed, slots, G, g, E, k, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// grad (G, g, E, C) in `dtype` with element strides strides[0..3]; top_idx
// (G, g, k) int64 and slots (G, g, k) int32 as the forward gave them; out
// (G, g, k) float32, contiguous, written whole.  Returns a cudaError_t.
extern "C" int moe_dispatch_bwd(const void* grad, const void* top_idx, const void* slots, void* out, int G, int g,
                                int k, int dtype, const int64_t* strides, void* stream) {
  if (G < 1 || g < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(G) * g * k;
  const int blocks = static_cast<int>(n / THREADS + 1 < 132 * 16 ? n / THREADS + 1 : 132 * 16);
  const auto* ti = static_cast<const int64_t*>(top_idx);
  const auto* sl = static_cast<const int32_t*>(slots);
  auto* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      grad_kernel<F32><<<blocks, THREADS, 0, st>>>(static_cast<const uint32_t*>(grad), ti, sl, o, n, g, k,
                                                    strides[0], strides[1], strides[2], strides[3]);
      break;
    case 1:
      grad_kernel<BF16><<<blocks, THREADS, 0, st>>>(static_cast<const uint16_t*>(grad), ti, sl, o, n, g, k,
                                                     strides[0], strides[1], strides[2], strides[3]);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
