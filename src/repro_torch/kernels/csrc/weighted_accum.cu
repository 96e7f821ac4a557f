// Weighted gradient accumulation over a list of tensors for Hopper (sm_90a),
// plain CUDA C++ behind a C interface: one launch for a whole tree.
//
// Replaces the TPU kernel `weighted_accum` / `_accum_kernel` and its tree
// form `weighted_accum_tree` of src/repro/kernels/weighted_accum.py:
//   out[i] = (float(acc[i]) + scale * float(g[i])) cast to acc's type,
// for every tensor of a list, acc and g each float32 or bfloat16 (one pair
// of types per launch), with `scale` read from a one-element float32 array
// in device memory (the TPU kernel's scalar prefetch), so a weight that
// lives on the device (a masked slot's 0/1) costs the host no
// synchronisation.  `out` may be `acc` itself: the port accumulates in place.
//
// Arithmetic: __fmul_rn then __fadd_rn, two float32 roundings that nvcc may
// not contract into one FMA, so every element equals the plain version's
// `acc.float() + scale * g.float()` bit for bit, and at scale 1 the inline
// sum `acc + g` of the train step.
//
// What bounds it on the H100: nothing but bytes.  One float32 accumulation
// reads acc and g and writes out, 12 bytes an element for two operations, so
// smollm-360m's gradient tree (290 tensors, 361,821,120 floats) takes at
// least 1.30 ms at 3.35 TB/s.  What the design does about it:
//   - one launch per tree: the per-tensor table (addresses, sizes, heads and
//     a prefix over chunks) is one __grid_constant__ parameter of up to
//     32,764 bytes (CUDA >= 12.1), so the table travels with the launch (no
//     copy of its own) and 290 tiny tensors cost one launch, not 290;
//   - one block for each fixed chunk of CHUNK_VECS vectors of the
//     concatenated tree; a block finds the tensor of its chunk by a binary
//     search of the prefix (the same index for every thread, a broadcast
//     from the constant bank).  One block a chunk ran faster on the card
//     than a persistent grid of a few blocks an SM walking the chunks
//     (PERF.md, Findings);
//   - each thread issues UNROLL 16-byte loads of acc and of g before it
//     computes and stores, so enough bytes are in flight to cover the
//     memory's latency; loads and stores are streaming (evict-first: a
//     tree is far larger than the 50 MB L2, and each byte is touched once);
//   - each element is read once and written once; where the three addresses
//     of a tensor do not share their alignment to a vector, that tensor goes
//     one element at a time, and an aligned tensor's scalar head and tail
//     are taken by its first and last chunk.
// The host side (kernels/weighted_accum.py) plans the launches: one group per
// (acc type, g type), at most MAX_TENSORS tensors a table, empty tensors
// left out.  Its pure-Python planner mirrors the chunk walk below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                        // vectors of acc and of g in flight per thread
constexpr int CHUNK_VECS = THREADS * UNROLL * 2;  // vectors per chunk: 8192 float32 elements
constexpr int MAX_TENSORS = 800;

// The launch's table, passed by value.  Tensor i owns chunks
// [chunk_start[i], chunk_start[i + 1]); head[i] is the number of scalar
// elements before its first vector, or -1 when the tensor has no vectors
// (its addresses are not aligned alike) and every element goes one at a time.
struct Table {
  uint64_t acc[MAX_TENSORS];
  uint64_t g[MAX_TENSORS];
  uint64_t out[MAX_TENSORS];
  int64_t n[MAX_TENSORS];
  uint64_t scale;  // address of one float32 on the device
  int32_t count;   // tensors in this table
  int32_t chunk_start[MAX_TENSORS + 1];
  int32_t head[MAX_TENSORS];
};
static_assert(sizeof(Table) <= 32764, "a kernel's parameters may take 32,764 bytes at most");
static_assert(sizeof(Table) == 40 * MAX_TENSORS + 16,
              "no padding: the layout must match the planner's (kernels/weighted_accum.py)");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <typename A, typename G>
__device__ __forceinline__ A axpy(A a, G g, float s) {
  return from_float<A>(__fadd_rn(to_float(a), __fmul_rn(s, to_float(g))));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// One vector of 8, 16 or 32 bytes, loaded or stored with the streaming hint
// (ld.global.cs / st.global.cs).
template <typename V>
__device__ __forceinline__ V load_stream(const V* p) {
  static_assert(sizeof(V) == 8 || sizeof(V) == 16 || sizeof(V) == 32, "8, 16 or 32-byte vectors");
  V r;
  if constexpr (sizeof(V) == 8) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(&r, &x, 8);
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4 x[sizeof(V) / 16];
#pragma unroll
    for (int i = 0; i < (int)(sizeof(V) / 16); ++i) x[i] = __ldcs(q + i);
    memcpy(&r, x, sizeof(V));
  }
  return r;
}

template <typename V>
__device__ __forceinline__ void store_stream(V* p, const V& v) {
  static_assert(sizeof(V) == 8 || sizeof(V) == 16, "8 or 16-byte vectors");
  if constexpr (sizeof(V) == 8) {
    uint2 x;
    memcpy(&x, &v, 8);
    __stcs(reinterpret_cast<uint2*>(p), x);
  } else {
    uint4 x;
    memcpy(&x, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), x);
  }
}

// Scalar elements [lo, hi) of one tensor, spread over the block's threads.
// acc and out may be the same array, so neither is __restrict__.
template <typename A, typename G>
__device__ __forceinline__ void scalars(const A* acc, const G* g, A* out, float s, int64_t lo, int64_t hi) {
  for (int64_t i = lo + threadIdx.x; i < hi; i += THREADS) out[i] = axpy(acc[i], g[i], s);
}

// N elements per vector: 16 bytes of the accumulator.
template <typename A, typename G, int N>
__global__ void __launch_bounds__(THREADS) accum_tree_kernel(const __grid_constant__ Table t) {
  const float s = __ldg(reinterpret_cast<const float*>(t.scale));
  const int c = blockIdx.x;  // this block's chunk
  int lo = 0, hi = t.count - 1;  // the tensor i with chunk_start[i] <= c < chunk_start[i + 1]
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const int j = c - t.chunk_start[i];  // the chunk's index within its tensor
  const bool last = c + 1 == t.chunk_start[i + 1];
  const A* acc = reinterpret_cast<const A*>(t.acc[i]);
  const G* g = reinterpret_cast<const G*>(t.g[i]);
  A* out = reinterpret_cast<A*>(t.out[i]);
  const int64_t n = t.n[i];
  const int head = t.head[i];
  if (head < 0) {  // addresses not aligned alike: this chunk's elements one at a time
    const int64_t span = (int64_t)CHUNK_VECS * N;  // elements per chunk
    const int64_t e0 = (int64_t)j * span;
    scalars(acc, g, out, s, e0, e0 + span < n ? e0 + span : n);
    return;
  }
  const int64_t nvec = (n - head) / N;
  if (j == 0) scalars(acc, g, out, s, 0, head);
  if (last) scalars(acc, g, out, s, head + nvec * N, n);
  const Vec<A, N>* av = reinterpret_cast<const Vec<A, N>*>(acc + head);
  const Vec<G, N>* gv = reinterpret_cast<const Vec<G, N>*>(g + head);
  Vec<A, N>* ov = reinterpret_cast<Vec<A, N>*>(out + head);
  const int64_t v0 = (int64_t)j * CHUNK_VECS;
  const int64_t v1 = v0 + CHUNK_VECS < nvec ? v0 + CHUNK_VECS : nvec;
  for (int64_t v = v0 + threadIdx.x; v < v1; v += THREADS * UNROLL) {
    Vec<A, N> a[UNROLL];
    Vec<G, N> b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // every load issued before the first store
      if (v + u * THREADS < v1) {
        a[u] = load_stream(av + v + u * THREADS);
        b[u] = load_stream(gv + v + u * THREADS);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v + u * THREADS < v1) {
        Vec<A, N> o;
#pragma unroll
        for (int e = 0; e < N; ++e) o.v[e] = axpy(a[u].v[e], b[u].v[e], s);
        store_stream(ov + v + u * THREADS, o);
      }
    }
  }
}

template <typename A, typename G>
int launch(const Table& t, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(A);
  const int total = t.chunk_start[t.count];
  if (total <= 0) return 0;
  accum_tree_kernel<A, G, N><<<total, THREADS, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// table: a host buffer holding one Table (the planner's packed bytes);
// acc_dtype and g_dtype are 0 for float32 and 1 for bfloat16, and every out
// has acc's type.  Returns a cudaError_t (0 = launched).
extern "C" int weighted_accum_tree_fwd(const void* table, int acc_dtype, int g_dtype, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.count < 1 || t.count > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (acc_dtype * 2 + g_dtype) {
    case 0: return launch<float, float>(t, st);
    case 1: return launch<float, __nv_bfloat16>(t, st);
    case 2: return launch<__nv_bfloat16, float>(t, st);
    case 3: return launch<__nv_bfloat16, __nv_bfloat16>(t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
