// RWKV6 chunked WKV recurrence for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `rwkv6_scan` / `_rwkv6_kernel` of
// src/repro/kernels/rwkv6_scan.py.  Per (batch, head) it walks the sequence in
// chunks of `chunk` tokens and carries the (D, D) fp32 state S across them.
// Inside a chunk, with lw = log(max(w, 1e-38)), L = cumsum(lw), Lprev = L - lw
// and Lmid = L[chunk/2 - 1] (0 when chunk is 1):
//   y  = (r e^Lprev) S + tril_-1((r e^(Lprev-Lmid)) (k e^(Lmid-L))^T) v + (sum_d r u k) v
//   S' = e^Lend S + (k e^(Lend-L))^T v
// The output y is fp32 (the inputs' type), and so is the final state.
//
// What bounds it on the H100: at the serving shape (rwkv6-1.6b prefill, one
// prompt of 16..256 tokens, 32 heads of 64) a call moves about 11 MB (the
// four (T, H, D) inputs, y and the end state; the model carries no start
// state into a prefill) and does about 0.17 GFLOP of fp32 work, so the
// card's bound is the bytes (about 3.3 us), with the fp32 CUDA-core time
// (about 2.5 us) close behind.  This first kernel has one
// block per (batch, head): 32 blocks on 132 SMs at that shape, each walking
// its chunks in order with a barrier between the steps of a chunk, so it is
// bound by the latency of that serial walk, not by the card's rates.  What
// the design does about the bytes: each input element is read from device
// memory once, straight from the (B, T, H, D) layout by strides (no
// transposed copies), the log of the decay is taken here, and the state never
// leaves shared memory between chunks.  Left for later: the products on the
// tensor cores (wgmma, TF32 or bf16 with an fp32 state), TMA loads of the
// next chunk's tiles while this one computes, and a grid that splits D's
// value columns over more blocks to fill the card.
//
// Numerics: the caller clamps the per-token log-decay to >= -4 and the chunk
// is at most 32, so after the mid-chunk recentring each factor e^(Lprev-Lmid)
// and e^(Lmid-L) is at most e^64, finite in fp32.  Their product above the
// diagonal (s >= t) could reach e^128 = inf, so only the entries with s < t
// are ever formed: the score of a pair outside the strict lower triangle is
// never computed, not masked after the fact.  Padded steps (k = 0, w = 1)
// give lw = 0 and leave S exactly unchanged.
//
// Layout: one block of 256 threads per (b, h).  Shared memory (dynamic, up
// to 151 KB at D = 128) holds S (D x D), the chunk's five (32 x D) tiles
// (r then the recentred queries, k then the recentred keys, v, lw then
// r e^Lprev, L then k e^(Lend-L); rows padded to D + 1 floats so column walks
// hit distinct banks), the (32 x 32) scores and three per-column vectors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 32;  // longest chunk; the overflow contract holds up to 32

template <int D>
struct Layout {
  static constexpr int DP = D + 1;                      // padded row stride of the chunk tiles
  static constexpr int TILE = CMAX * DP;                // one (CMAX x D) tile
  static constexpr int S_OFF = 0;                       // S (D x D), unpadded
  static constexpr int Q_OFF = S_OFF + D * D;           // r, then r e^(Lprev - Lmid)
  static constexpr int K_OFF = Q_OFF + TILE;            // k, then k e^(Lmid - L)
  static constexpr int V_OFF = K_OFF + TILE;            // v
  static constexpr int RD_OFF = V_OFF + TILE;           // lw, then r e^Lprev
  static constexpr int KD_OFF = RD_OFF + TILE;          // L, then k e^(Lend - L)
  static constexpr int A_OFF = KD_OFF + TILE;           // scores (CMAX x (CMAX + 1))
  static constexpr int LMID_OFF = A_OFF + CMAX * (CMAX + 1);
  static constexpr int LEND_OFF = LMID_OFF + D;
  static constexpr int U_OFF = LEND_OFF + D;
  static constexpr int DIAG_OFF = U_OFF + D;
  static constexpr int FLOATS = DIAG_OFF + CMAX;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int D>
__global__ void __launch_bounds__(THREADS) rwkv6_fwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out, int T, int H, int chunk,
    int64_t rsb, int64_t rst, int64_t rsh, int64_t ksb, int64_t kst, int64_t ksh,
    int64_t vsb, int64_t vst, int64_t vsh, int64_t wsb, int64_t wst, int64_t wsh,
    int64_t ysb, int64_t yst, int64_t ysh) {
  using Lay = Layout<D>;
  constexpr int DP = Lay::DP;
  constexpr int RG = THREADS / D;           // row groups: threads sharing one column e
  constexpr int RY = (CMAX + RG - 1) / RG;  // output rows per thread
  constexpr int RS = D / RG;                // state rows per thread
  extern __shared__ float smem[];
  float* S = smem + Lay::S_OFF;
  float* Qs = smem + Lay::Q_OFF;
  float* Ks = smem + Lay::K_OFF;
  float* Vs = smem + Lay::V_OFF;
  float* RDs = smem + Lay::RD_OFF;
  float* KDs = smem + Lay::KD_OFF;
  float* A = smem + Lay::A_OFF;
  float* Lmid = smem + Lay::LMID_OFF;
  float* Lend = smem + Lay::LEND_OFF;
  float* Us = smem + Lay::U_OFF;
  float* diag = smem + Lay::DIAG_OFF;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int e = tid % D;   // this thread's value column in the y and S passes
  const int g = tid / D;   // its row group
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int64_t bh = (int64_t)b * H + h;
  for (int i = tid; i < D * D; i += THREADS) S[i] = s0 ? s0[bh * D * D + i] : 0.f;
  if (tid < D) Us[tid] = u[(int64_t)h * D + tid];

  const float* rb = r + b * rsb + h * rsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  const float* wb = w + b * wsb + h * wsh;
  float* yb = y + b * ysb + h * ysh;
  const int C = chunk;

  for (int c0 = 0; c0 < T; c0 += C) {
    __syncthreads();  // the previous chunk's state pass has finished reading the tiles
    // 1. stage the chunk: r, k, v and lw = log(max(w, 1e-38))
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int64_t tt = c0 + t;
      Qs[t * DP + d] = rb[tt * rst + d];
      Ks[t * DP + d] = kb[tt * kst + d];
      Vs[t * DP + d] = vb[tt * vst + d];
      RDs[t * DP + d] = logf(fmaxf(wb[tt * wst + d], 1e-38f));
    }
    __syncthreads();
    // 2. the bonus diagonal sum_d r u k per row (one warp per row), and the
    //    cumulative log-decay L per column with its mid and end values
    for (int t = warp; t < C; t += THREADS / 32) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += Qs[t * DP + d] * Us[d] * Ks[t * DP + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) diag[t] = part;
    }
    if (tid < D) {
      float L = 0.f;
      for (int t = 0; t < C; ++t) {
        L += RDs[t * DP + tid];
        KDs[t * DP + tid] = L;
      }
      Lend[tid] = L;
      Lmid[tid] = C > 1 ? KDs[(C / 2 - 1) * DP + tid] : 0.f;
    }
    __syncthreads();
    // 3. decay-weighted rows, each element read and rewritten by one thread
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const float lw = RDs[t * DP + d];
      const float L = KDs[t * DP + d];
      const float Lprev = L - lw;
      const float rv = Qs[t * DP + d];
      const float kv = Ks[t * DP + d];
      RDs[t * DP + d] = rv * expf(Lprev);
      Qs[t * DP + d] = rv * expf(Lprev - Lmid[d]);
      Ks[t * DP + d] = kv * expf(Lmid[d] - L);
      KDs[t * DP + d] = kv * expf(Lend[d] - L);
    }
    __syncthreads();
    // 4. scores: strictly lower triangle by dot products, the bonus on the
    //    diagonal, 0 above it (never formed)
    for (int i = tid; i < C * C; i += THREADS) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) a += Qs[t * DP + d] * Ks[s * DP + d];
      } else if (s == t) {
        a = diag[t];
      }
      A[t * (CMAX + 1) + s] = a;
    }
    __syncthreads();
    // 5. y = (r e^Lprev) S + scores v, every row reading the chunk's old S
    {
      float acc[RY];
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float sde = S[d * D + e];
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          const int t = g + j * RG;
          if (t < C) acc[j] += RDs[t * DP + d] * sde;
        }
      }
      for (int s = 0; s < C; ++s) {
        const float vse = Vs[s * DP + e];
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          const int t = g + j * RG;
          if (t < C && s <= t) acc[j] += A[t * (CMAX + 1) + s] * vse;
        }
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const int t = g + j * RG;
        if (t < C) yb[(int64_t)(c0 + t) * yst + e] = acc[j];
      }
    }
    __syncthreads();  // every row has read the old S before any thread writes S'
    // 6. S' = e^Lend S + (k e^(Lend-L))^T v
    {
      float acc[RS];
#pragma unroll
      for (int j = 0; j < RS; ++j) acc[j] = 0.f;
      for (int s = 0; s < C; ++s) {
        const float vse = Vs[s * DP + e];
#pragma unroll
        for (int j = 0; j < RS; ++j) acc[j] += KDs[s * DP + g + j * RG] * vse;
      }
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int d = g + j * RG;
        S[d * D + e] = expf(Lend[d]) * S[d * D + e] + acc[j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += THREADS) s_out[bh * D * D + i] = S[i];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u, const float* s0,
           float* y, float* s_out, int B, int T, int H, int chunk, const int64_t* st, cudaStream_t stream) {
  static_assert(THREADS % D == 0, "a row group must cover whole columns");
  static_assert(Layout<D>::BYTES <= 232448, "shared memory above the 227 KB a block can have");
  // above 48 KB a block's shared memory must be dynamic and opted into
  cudaError_t err = cudaFuncSetAttribute(rwkv6_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Layout<D>::BYTES);
  if (err != cudaSuccess) return (int)err;
  rwkv6_fwd_kernel<D><<<B * H, THREADS, Layout<D>::BYTES, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, H, chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, T, H, D) float32 with a unit stride on D; `strides` holds the
// batch, time and head strides (in elements) of r, k, v, w and y in that
// order.  u (H, D) and s0 (B, H, D, D, or null for zeros) contiguous float32;
// y (B, T, H, D) and s_out (B, H, D, D) float32.  1 <= chunk <= 32 and
// T % chunk == 0.  Returns a cudaError_t (0 = launched).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                              const void* s0, void* y, void* s_out, int B, int T, int H, int D, int chunk,
                              const int64_t* strides, void* stream) {
  if (chunk < 1 || chunk > CMAX || T % chunk != 0) return (int)cudaErrorInvalidValue;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, strides, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, strides, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, strides, s);
    case 128: return launch<128>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
