// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: causal and sliding-window GQA
// attention with online softmax (fp32 running max m, denominator l and
// accumulator), logit softcap and a query offset, skipping key tiles that the
// causal mask or the window leaves unreachable.
//
// What bounds it on the H100: at the serving shapes (smollm-360m prefill,
// one prompt of 8..256 tokens, 15 query heads over 5 KV heads, head_dim 64)
// the work is small: about 1.3 MB moved and 0.13 GFLOP at 256 tokens, so the
// card's bound is the bytes (well under a microsecond).  This first kernel
// does its products on the CUDA cores in fp32, not on the tensor cores, so it
// is bounded by its FMA issue rate and by launch latency.  What the design
// does about the bytes: each block stages one K tile and one V tile of its
// KV head in shared memory and every query row of the block reads them from
// there, so K/V are read from device memory once per (block, tile), and the
// scores never leave registers.  wgmma, TMA and a pipelined tile ring are
// the later step.
//
// Layout: one block of 128 threads per (q tile, batch * query head).  A query
// row is owned by LANES = DH / 16 neighbouring threads, each holding 16 of
// its head dims (interleaved, dim = i * LANES + lane) for q and for the
// accumulator; a score is the lanes' partial dot products summed with
// shuffles.  Query head h reads KV head h / G for any group size G.
// Masked scores are NEG_INF = -2e38 (finite) and their probability is 0, and
// the denominator is clamped to 1e-37, so a row with no key to attend gives
// 0, never NaN.  Ragged edges (Sq, Sk not multiples of the tiles) are masked
// here, not asserted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int THREADS = 128;
constexpr int DPT = 16;     // head dims held by one thread
constexpr int KCHUNK = 16;  // keys scored per online-softmax update

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int Sq, int Sk, int H, int Hkv,
    int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh,
    int causal, int window, float softcap, int q_offset, float scale) {
  constexpr int LANES = DH / DPT;        // threads per query row: 1, 2, 4, 8 or 16
  constexpr int ROWS = THREADS / LANES;  // query rows per block
  constexpr int BK = 4096 / DH;          // keys per shared-memory tile (32 KB for K and V)
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x % LANES;
  const int r = threadIdx.x / LANES;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int q_pos = q_offset + qi;

  float qr[DPT];
  float acc[DPT];
  const T* qp = q + b * qsb + (int64_t)min(qi, Sq - 1) * qss + h * qsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = to_f(qp[i * LANES + lane]);
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // Key range this q tile can reach; tiles outside it are skipped whole.
  const int first_q = q_offset + q0;
  const int last_q = q_offset + min(q0 + ROWS, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_begin = window > 0 ? max(0, first_q - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * BK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH;
      const int d = idx % DH;
      const int kp = kbase + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = to_f(kb[(int64_t)kp * kss + d]);
        vv = to_f(vb[(int64_t)kp * vss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < BK; c += KCHUNK) {
      float s[KCHUNK];
      unsigned valid = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KCHUNK; ++jj) {
        const int j = c + jj;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][i * LANES + lane];
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        float sc = part * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int kp = kbase + j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= q_pos;
        if (window > 0) ok = ok && kp > q_pos - window;
        s[jj] = ok ? sc : NEG_INF;
        valid |= (ok ? 1u : 0u) << jj;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < KCHUNK; ++jj) {
        const float p = (valid >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * vs[c + jj][i * LANES + lane];
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-37f);
    T* op = o + b * osb + (int64_t)qi * oss + h * osh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * LANES + lane] = from_f<T>(acc[i] / denom);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int Hkv,
            const int64_t* st, int causal, int window, float softcap, int q_offset, cudaStream_t stream) {
  constexpr int ROWS = THREADS / (DH / DPT);
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  flash_fwd_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      Sq, Sk, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap, q_offset, (float)pow((double)DH, -0.5));
}

template <typename T>
int dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
                int Hkv, const int64_t* st, int causal, int window, float softcap, int q_offset,
                cudaStream_t stream) {
  switch (Dh) {
    case 16: launch<T, 16>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, stream); break;
    case 256: launch<T, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), o (B, Sq, H, Dh), each with a unit
// stride on the last axis; `strides` holds the batch, sequence and head
// strides (in elements) of q, k, v and o in that order.  dtype: 0 float32,
// 1 bfloat16 (all four tensors alike).  window <= 0 means no window.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int Hkv, int Dh, const int64_t* strides, int causal,
                                   int window, float softcap, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(Dh, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap,
                                      q_offset, s);
  return (int)cudaErrorInvalidValue;
}
