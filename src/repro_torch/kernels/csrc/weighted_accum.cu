// Weighted gradient accumulation for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `weighted_accum` / `_accum_kernel` of
// src/repro/kernels/weighted_accum.py:
//   out[i] = (float(acc[i]) + scale * float(g[i])) cast to acc's type,
// for acc and g each float32 or bfloat16, with `scale` read from a one-element
// float32 array in device memory (the TPU kernel's scalar prefetch), so one
// build serves every scale and a weight that lives on the device (a masked
// slot's 0/1, a token weight) costs the host no synchronisation.  `out` may
// be `acc` itself: the port accumulates in place.
//
// Arithmetic: __fmul_rn then __fadd_rn, two float32 roundings that nvcc may
// not contract into one FMA, so every element equals the plain version's
// `acc.float() + scale * g.float()` (a multiply and an add in float32) bit
// for bit, and at scale 1 the inline sum `acc + g` of the train step.
//
// What bounds it on the H100: nothing but bytes.  One float32 accumulation
// reads acc and g and writes out, 12 bytes an element for two operations, so
// smollm-360m's gradient tree (361,821,120 floats) takes at least 1.30 ms at
// 3.35 TB/s.  What the design does about it: each element is read once and
// written once; 16-byte vector loads and stores where the three pointers are
// aligned alike (a scalar head brings an offset view to that alignment, a
// scalar tail takes the rest); a grid-stride loop over at most 16 blocks a
// multiprocessor, so large tensors need no huge grid.  Left for later: one
// launch for a whole list of tensors (a device array of pointers and sizes);
// this version is launched once per tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // the H100's 132 multiprocessors, 16 blocks each at most

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

// N elements per vector: 16 bytes of the accumulator.  Elements [0, head) and
// [head + nvec * N, n) go one at a time; [head, head + nvec * N) N at a time.
// acc and out may be the same array, so neither is __restrict__.
template <typename A, typename G, int N>
__global__ void __launch_bounds__(THREADS) accum_kernel(const A* acc, const G* __restrict__ g, A* out,
                                                         const float* __restrict__ scale, int64_t n, int64_t head,
                                                         int64_t nvec) {
  const float s = __ldg(scale);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const Vec<A, N>* av = reinterpret_cast<const Vec<A, N>*>(acc + head);
  const Vec<G, N>* gv = reinterpret_cast<const Vec<G, N>*>(g + head);
  Vec<A, N>* ov = reinterpret_cast<Vec<A, N>*>(out + head);
  for (int64_t i = first; i < nvec; i += stride) {
    const Vec<A, N> a = av[i];
    const Vec<G, N> b = gv[i];
    Vec<A, N> o;
#pragma unroll
    for (int j = 0; j < N; ++j) o.v[j] = axpy(a.v[j], b.v[j], s);
    ov[i] = o;
  }
  const int64_t tail0 = head + nvec * N;
  const int64_t scalars = head + (n - tail0);
  for (int64_t j = first; j < scalars; j += stride) {
    const int64_t idx = j < head ? j : tail0 + (j - head);
    out[idx] = axpy(acc[idx], g[idx], s);
  }
}

// Elements before the first N-aligned one of an array of T at address p (p is T-aligned).
template <typename T, int N>
int64_t head_of(const void* p) {
  const uint64_t e = (uint64_t)(uintptr_t)p / sizeof(T);
  return (int64_t)((N - e % N) % N);
}

template <typename A, typename G>
int launch(const void* acc, const void* g, void* out, const float* scale, int64_t n, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(A);
  int64_t head = head_of<A, N>(acc);
  int64_t nvec = 0;
  if (head == head_of<G, N>(g) && head == head_of<A, N>(out) && head < n) {
    nvec = (n - head) / N;
  } else {
    head = n;  // the three arrays do not line up: every element one at a time
  }
  const int64_t items = nvec > n - nvec * N ? nvec : n - nvec * N;
  int64_t blocks = (items + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  accum_kernel<A, G, N><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const A*>(acc), static_cast<const G*>(g), static_cast<A*>(out), scale, n, head, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// acc, g, out: n contiguous elements each; acc_dtype and g_dtype are 0 for
// float32 and 1 for bfloat16, and out has acc's type (out may equal acc).
// scale: one float32 in device memory.  Returns a cudaError_t (0 = launched).
extern "C" int weighted_accum_fwd(const void* acc, const void* g, void* out, const void* scale, int64_t n,
                                  int acc_dtype, int g_dtype, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (acc_dtype * 2 + g_dtype) {
    case 0: return launch<float, float>(acc, g, out, s, n, st);
    case 1: return launch<float, __nv_bfloat16>(acc, g, out, s, n, st);
    case 2: return launch<__nv_bfloat16, float>(acc, g, out, s, n, st);
    case 3: return launch<__nv_bfloat16, __nv_bfloat16>(acc, g, out, s, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
