// Ragged paged-attention decode for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `paged_attention` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py: one query token per slot attends that
// slot's KV positions 0..length-1, which live in fixed-size pages of a shared
// pool addressed through the slot's page-table row.  Pages that are
// unallocated (-1), past `length`, or wholly outside the sliding window are
// skipped (the predicate of `_paged_kernel` and its `kv_index`).  Logit
// softcap, and int8 pools with per-(token, kv-head) bf16 scales dequantised
// here.  An empty slot (length 0) gives 0.
//
// What bounds it on the H100: decoding reads each live K/V token once and
// does 4 * H * Dh FLOPs per token against 2 * Hkv * Dh * bytes of KV, about
// 1.5 FLOP per byte at smollm-360m's 15/5 heads in bf16, far below the ~295
// FLOP/byte where the tensor cores would become the limit.  So the bytes of
// the live pages bound it.  What the design does about that: one block per
// (slot, kv head) covers the G query heads that share the head's pages, so
// each page is read from device memory once per group, not G times; the
// block's four warps take alternate pages so four page reads are in flight,
// and merge their online-softmax states (m, l, acc in fp32) at the end; the
// block reads its own page-table row and length, so a dead page costs no
// bytes.  Vectorised 16-byte loads and more warps per slot are the later step.
//
// Layout inside a warp: a query head is owned by LANES = DH / 16 neighbouring
// threads, each holding 16 of its dims (interleaved, dim = i * LANES + lane);
// a score is the lanes' partial dot products summed with shuffles.  A warp
// covers 32 / LANES query heads at once; larger groups take several passes.
// Masked scores are NEG_INF = -2e38 (finite) with probability 0, and the
// denominator is clamped to 1e-37.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NW = 4;  // warps per block
constexpr int DPT = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// TQ: query and output type; TKV: pool type (TQ itself, or int8_t with scales).
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(NW * 32) paged_fwd_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ pages, const int* __restrict__ lengths, TQ* __restrict__ out,
    int H, int Hkv, int n_pages_p1, int page_size, int P, int window, float softcap, float scale) {
  constexpr int LANES = DH / DPT;
  constexpr int ROWS = 32 / LANES;               // query heads per warp pass
  constexpr int CT = DH <= 64 ? 16 : 1024 / DH;  // tokens staged per chunk (<= 16)
  constexpr bool INT8 = sizeof(TKV) == 1;
  __shared__ float ks[NW][CT][DH];
  __shared__ float vs[NW][CT][DH];
  __shared__ float m_sh[NW][ROWS];
  __shared__ float l_sh[NW][ROWS];
  __shared__ float acc_sh[NW][ROWS][DH];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int w = threadIdx.x / 32;
  const int wl = threadIdx.x % 32;
  const int r = wl / LANES;
  const int lane = wl % LANES;
  const int length = lengths[b];
  const int* row = pages + (int64_t)b * P;

  // live page range: j * page_size < length, and (window) (j + 1) * page_size > length - window
  const int j_lo = window > 0 ? max(0, length - window) / page_size : 0;
  const int j_hi = min(P, (length + page_size - 1) / page_size);

  for (int g0 = 0; g0 < G; g0 += ROWS) {
    const int g = g0 + r;
    const bool row_ok = g < G;
    const int h = hk * G + min(g, G - 1);
    float qr[DPT];
    float acc[DPT];
    const TQ* qp = q + ((int64_t)b * H + h) * DH;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = to_f(qp[i * LANES + lane]);
      acc[i] = 0.f;
    }
    float m = NEG_INF;
    float l = 0.f;

    for (int j = j_lo + w; j < j_hi; j += NW) {
      const int pg = row[j];
      if (pg < 0 || pg >= n_pages_p1) continue;  // warp-uniform: the whole warp skips the page
      for (int t0 = 0; t0 < page_size && j * page_size + t0 < length; t0 += CT) {
        __syncwarp();
        for (int idx = wl; idx < CT * DH; idx += 32) {
          const int tt = idx / DH;
          const int d = idx % DH;
          const int t = t0 + tt;
          float kv = 0.f, vv = 0.f;
          if (t < page_size) {
            const int64_t tok = ((int64_t)pg * page_size + t) * Hkv + hk;
            kv = to_f(k_pool[tok * DH + d]);
            vv = to_f(v_pool[tok * DH + d]);
            if constexpr (INT8) {
              kv *= __bfloat162float(k_scale[tok]);
              vv *= __bfloat162float(v_scale[tok]);
            }
          }
          ks[w][tt][d] = kv;
          vs[w][tt][d] = vv;
        }
        __syncwarp();
        float s[CT];
        unsigned valid = 0u;
        float cmax = NEG_INF;
#pragma unroll
        for (int tt = 0; tt < CT; ++tt) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPT; ++i) part += qr[i] * ks[w][tt][i * LANES + lane];
#pragma unroll
          for (int off = LANES / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          float sc = part * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          const int t = t0 + tt;
          const int kp = j * page_size + t;
          bool ok = t < page_size && kp < length;  // decode causality: the query sits at length - 1
          if (window > 0) ok = ok && kp > length - 1 - window;
          s[tt] = ok ? sc : NEG_INF;
          valid |= (ok ? 1u : 0u) << tt;
          cmax = fmaxf(cmax, s[tt]);
        }
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
        for (int tt = 0; tt < CT; ++tt) {
          const float p = (valid >> tt) & 1u ? expf(s[tt] - m_new) : 0.f;
          l += p;
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[i] += p * vs[w][tt][i * LANES + lane];
        }
        m = m_new;
      }
    }

    // merge the warps' partial softmax states
    if (lane == 0) {
      m_sh[w][r] = m;
      l_sh[w][r] = l;
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc_sh[w][r][i * LANES + lane] = acc[i];
    __syncthreads();
    if (w == 0 && row_ok) {
      float m_tot = NEG_INF;
#pragma unroll
      for (int u = 0; u < NW; ++u) m_tot = fmaxf(m_tot, m_sh[u][r]);
      float l_tot = 0.f;
      float o[DPT];
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[i] = 0.f;
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        const float f = expf(m_sh[u][r] - m_tot);
        l_tot += l_sh[u][r] * f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) o[i] += acc_sh[u][r][i * LANES + lane] * f;
      }
      const float denom = fmaxf(l_tot, 1e-37f);
      TQ* op = out + ((int64_t)b * H + h) * DH;
#pragma unroll
      for (int i = 0; i < DPT; ++i) op[i * LANES + lane] = from_f<TQ>(o[i] / denom);
    }
    __syncthreads();
  }
}

template <typename TQ, typename TKV, int DH>
void launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs, const int* pages,
            const int* lengths, void* out, int B, int H, int Hkv, int n_pages_p1, int page_size, int P,
            int window, float softcap, cudaStream_t stream) {
  paged_fwd_kernel<TQ, TKV, DH><<<B * Hkv, NW * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs), pages, lengths,
      static_cast<TQ*>(out), H, Hkv, n_pages_p1, page_size, P, window, softcap, (float)pow((double)DH, -0.5));
}

template <typename TQ, typename TKV>
int dispatch_dh(int Dh, const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                const int* pages, const int* lengths, void* out, int B, int H, int Hkv, int n_pages_p1,
                int page_size, int P, int window, float softcap, cudaStream_t s) {
#define PAGED_CASE(D)                                                                                      \
  case D:                                                                                                  \
    launch<TQ, TKV, D>(q, kp, vp, ks, vs, pages, lengths, out, B, H, Hkv, n_pages_p1, page_size, P, window, \
                       softcap, s);                                                                        \
    break;
  switch (Dh) {
    PAGED_CASE(16)
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Dh); pools (n_pages_p1, page_size, Hkv, Dh), the last page being
// scratch; scales (n_pages_p1, page_size, Hkv) bf16 for int8 pools, else
// null; pages (B, P) int32 with -1 = unallocated; lengths (B,) int32; out
// (B, H, Dh).  All contiguous.  q_dtype: 0 float32, 1 bfloat16 (the output
// has q's type; non-int8 pools have it too).  kv_int8: 1 for int8 pools.
// window <= 0 means no window.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                                   const void* v_scale, const int* pages, const int* lengths, void* out,
                                   int q_dtype, int kv_int8, int B, int H, int Hkv, int Dh, int n_pages_p1,
                                   int page_size, int P, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !kv_int8)
    return dispatch_dh<float, float>(Dh, q, k_pool, v_pool, k_scale, v_scale, pages, lengths, out, B, H, Hkv,
                                     n_pages_p1, page_size, P, window, softcap, s);
  if (q_dtype == 1 && !kv_int8)
    return dispatch_dh<__nv_bfloat16, __nv_bfloat16>(Dh, q, k_pool, v_pool, k_scale, v_scale, pages, lengths,
                                                     out, B, H, Hkv, n_pages_p1, page_size, P, window, softcap,
                                                     s);
  if (q_dtype == 0 && kv_int8)
    return dispatch_dh<float, int8_t>(Dh, q, k_pool, v_pool, k_scale, v_scale, pages, lengths, out, B, H, Hkv,
                                      n_pages_p1, page_size, P, window, softcap, s);
  if (q_dtype == 1 && kv_int8)
    return dispatch_dh<__nv_bfloat16, int8_t>(Dh, q, k_pool, v_pool, k_scale, v_scale, pages, lengths, out, B,
                                              H, Hkv, n_pages_p1, page_size, P, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
