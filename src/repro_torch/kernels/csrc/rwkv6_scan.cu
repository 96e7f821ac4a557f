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
// (about 2.5 us) close behind.  What holds a scan back is the serial walk
// over its chunks, so the design fills the card and shortens each chunk's
// serial steps:
//   - The grid is one block of 256 threads per (batch, head, block of EC = 16
//     value columns): the columns e of y and of S are independent, so a
//     block keeps only its (D x EC) slice of S and writes its EC columns of
//     y and of the end state.  At rwkv6-1.6b's prefill that is 4 blocks a
//     head, 128 blocks, one an SM.  Each block computes the chunk's decay
//     rows and its (C x C) scores itself (about C^2 D / 2 FMAs a chunk that
//     it shares with the head's other blocks).
//   - Prefetch: while chunk c is computed, chunk c + 1's r, k and w tiles
//     and the block's columns of v land in a second shared-memory stage by
//     cp.async, 16 bytes a copy, straight from the (B, T, H, D) layout by
//     strides (no transposed copies), neighbouring threads on neighbouring
//     pieces of a token's row.  Where a pointer or a stride is not 16-byte
//     aligned the same kernel copies 4 bytes at a time.
//   - Short serial steps, three barriers a chunk: the log-decay, its
//     cumulative sum over the chunk (a warp-shuffle scan, one lane a token,
//     four columns at once), the decay-weighted rows (written in place over
//     the stage's r, k and w) and the bonus' partial sums are one pass; the
//     scores are 4 x 4 tiles of the lower triangle, each taken by four
//     lanes over quarters of D; y and the state update are one pass, the
//     new S going to a second slice so that no barrier separates them, each
//     sum split in two halves for independent FMA chains.  The scan is bound
//     by the latency of these serial steps, 5 to 6 us a chunk on the H100
//     (PERF.md), not by the card's rates.
//   - The products stay fp32 FMA on the CUDA cores: at this shape they are
//     not the limit, and TF32 would endanger the 3e-4 tolerance.
//
// Numerics: the caller clamps the per-token log-decay to >= -4 and the chunk
// is at most 32, so after the mid-chunk recentring each factor e^(Lprev-Lmid)
// and e^(Lmid-L) is at most e^64, finite in fp32.  Their product above the
// diagonal (s >= t) could reach e^128 = inf, so only the entries with s < t
// are ever formed: in a tile on the diagonal the other products are
// predicated off, not computed and masked after the fact.  Padded steps
// (k = 0, w = 1) give lw = 0 and leave S exactly unchanged.
//
// Shared memory (dynamic, 78,976 bytes at D = 64, 145,024 at D = 128): two
// stages of r, k, w (32 x D each, rows padded to D + 4 floats so that a warp
// reading one column group down the chunk's rows hits distinct banks) and
// v's block columns (32 x EC); r e^Lprev (32 x D); two (D x EC) state
// slices; the (32 x 33) scores; e^Lend, u and the bonus' per-warp partial
// sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int CMAX = 32;  // longest chunk; the overflow contract holds up to 32
constexpr int EC = 16;    // value columns a block owns

template <int D>
struct Layout {
  static constexpr int DP = D + 4;                       // padded row stride of the chunk tiles
  static constexpr int TILE = CMAX * DP;                 // one (CMAX x D) tile
  static constexpr int R = 0, K = TILE, W = 2 * TILE;    // r, k, w within a stage (then Q, KK, KD in place)
  static constexpr int V = 3 * TILE;                     // v's block columns (CMAX x EC)
  static constexpr int STAGE = 3 * TILE + CMAX * EC;
  static constexpr int RD_OFF = 2 * STAGE;               // r e^Lprev
  static constexpr int S_OFF = RD_OFF + TILE;            // two (D x EC) state slices
  static constexpr int A_OFF = S_OFF + 2 * D * EC;       // scores (CMAX x (CMAX + 1))
  static constexpr int ELEND_OFF = A_OFF + CMAX * (CMAX + 1);
  static constexpr int U_OFF = ELEND_OFF + D;
  static constexpr int DIAG_OFF = U_OFF + D;             // the bonus' partial sums, one row a warp
  static constexpr int FLOATS = DIAG_OFF + NWARP * CMAX;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Four floats at src (16 bytes, or four 4-byte copies) to dst.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool vec16) {
  if (vec16) {
    cp16(dst, src);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp4(dst + j, src + j);
  }
}

// Chunk c0's r, k, w rows and the block's EC columns of v into a stage.
template <int D>
__device__ __forceinline__ void load_chunk(float* stage, const float* rb, const float* kb, const float* wb,
                                           const float* vb, int64_t rst, int64_t kst, int64_t wst, int64_t vst,
                                           int c0, int C, bool vec16) {
  using Lay = Layout<D>;
  constexpr int Q4 = D / 4;
  for (int i = threadIdx.x; i < C * Q4; i += THREADS) {
    const int t = i / Q4;
    const int d = 4 * (i % Q4);
    const int64_t tt = c0 + t;
    copy4(stage + Lay::R + t * Lay::DP + d, rb + tt * rst + d, vec16);
    copy4(stage + Lay::K + t * Lay::DP + d, kb + tt * kst + d, vec16);
    copy4(stage + Lay::W + t * Lay::DP + d, wb + tt * wst + d, vec16);
  }
  for (int i = threadIdx.x; i < C * (EC / 4); i += THREADS) {
    const int t = i / (EC / 4);
    const int e = 4 * (i % (EC / 4));
    copy4(stage + Lay::V + t * EC + e, vb + (int64_t)(c0 + t) * vst + e, vec16);
  }
  cp_commit();
}

template <int D>
__global__ void __launch_bounds__(THREADS) rwkv6_fwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out, int T, int H, int chunk, int vec16,
    int64_t rsb, int64_t rst, int64_t rsh, int64_t ksb, int64_t kst, int64_t ksh,
    int64_t vsb, int64_t vst, int64_t vsh, int64_t wsb, int64_t wst, int64_t wsh,
    int64_t ysb, int64_t yst, int64_t ysh) {
  using Lay = Layout<D>;
  constexpr int DP = Lay::DP;
  constexpr int NCB = D / EC;  // column blocks a head
  extern __shared__ __align__(16) float smem[];
  float* RD = smem + Lay::RD_OFF;
  float* S = smem + Lay::S_OFF;        // the state slice the chunk reads
  float* S_next = S + D * EC;          // and the one it writes
  float* A = smem + Lay::A_OFF;
  float* elend = smem + Lay::ELEND_OFF;
  float* Us = smem + Lay::U_OFF;
  float* diag = smem + Lay::DIAG_OFF;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int bh = blockIdx.x / NCB;
  const int e0 = (blockIdx.x % NCB) * EC;
  const int b = bh / H;
  const int h = bh % H;
  const int C = chunk;

  for (int i = tid; i < D * EC; i += THREADS) {
    const int d = i / EC, e = i % EC;
    S[i] = s0 ? s0[(int64_t)bh * D * D + d * D + e0 + e] : 0.f;
  }
  for (int i = tid; i < D; i += THREADS) Us[i] = u[(int64_t)h * D + i];

  const float* rb = r + b * rsb + h * rsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh + e0;
  const float* wb = w + b * wsb + h * wsh;
  float* yb = y + b * ysb + h * ysh + e0;
  load_chunk<D>(smem, rb, kb, wb, vb, rst, kst, wst, vst, 0, C, vec16);

  for (int c0 = 0, ci = 0; c0 < T; c0 += C, ++ci) {
    float* st = smem + (ci & 1) * Lay::STAGE;
    float* Q = st + Lay::R;   // r, then r e^(Lprev - Lmid)
    float* KK = st + Lay::K;  // k, then k e^(Lmid - L)
    float* KD = st + Lay::W;  // w, then k e^(Lend - L)
    const float* Vs = st + Lay::V;
    cp_wait_all();
    __syncthreads();  // this chunk has landed; the previous chunk's passes are done
    if (c0 + C < T) load_chunk<D>(smem + ((ci + 1) & 1) * Lay::STAGE, rb, kb, wb, vb, rst, kst, wst, vst, c0 + C, C,
                                  vec16);

    // 1. one lane a token, four columns a step: the log-decay, its cumulative
    //    sum over the chunk by a shuffle scan, the decay-weighted rows in
    //    place, e^Lend, and this warp's share of the bonus sum_d r u k
    {
      const int t = lane;
      float bonus = 0.f;
#pragma unroll
      for (int g = 0; g < (D / 4 + NWARP - 1) / NWARP; ++g) {
        const int d = 4 * (warp + g * NWARP);
        if (d >= D) break;  // warp-uniform
        float rv[4] = {0.f, 0.f, 0.f, 0.f}, kv[4] = {0.f, 0.f, 0.f, 0.f}, lw[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < C) {
          const float4 r4 = *reinterpret_cast<const float4*>(Q + t * DP + d);
          const float4 k4 = *reinterpret_cast<const float4*>(KK + t * DP + d);
          const float4 w4 = *reinterpret_cast<const float4*>(KD + t * DP + d);
          rv[0] = r4.x, rv[1] = r4.y, rv[2] = r4.z, rv[3] = r4.w;
          kv[0] = k4.x, kv[1] = k4.y, kv[2] = k4.z, kv[3] = k4.w;
          lw[0] = logf(fmaxf(w4.x, 1e-38f)), lw[1] = logf(fmaxf(w4.y, 1e-38f));
          lw[2] = logf(fmaxf(w4.z, 1e-38f)), lw[3] = logf(fmaxf(w4.w, 1e-38f));
        }
        float L[4] = {lw[0], lw[1], lw[2], lw[3]};
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float n = __shfl_up_sync(0xffffffffu, L[j], off);
            if (lane >= off) L[j] += n;
          }
        }
        float q4[4], rd4[4], kk4[4], kd4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float Lend = __shfl_sync(0xffffffffu, L[j], C - 1);
          const float Lmid = C > 1 ? __shfl_sync(0xffffffffu, L[j], C / 2 - 1) : 0.f;
          const float Lprev = L[j] - lw[j];
          rd4[j] = rv[j] * expf(Lprev);
          q4[j] = rv[j] * expf(Lprev - Lmid);
          kk4[j] = kv[j] * expf(Lmid - L[j]);
          kd4[j] = kv[j] * expf(Lend - L[j]);
          bonus += rv[j] * Us[d + j] * kv[j];
          if (lane == 0) elend[d + j] = expf(Lend);
        }
        if (t < C) {
          *reinterpret_cast<float4*>(RD + t * DP + d) = make_float4(rd4[0], rd4[1], rd4[2], rd4[3]);
          *reinterpret_cast<float4*>(Q + t * DP + d) = make_float4(q4[0], q4[1], q4[2], q4[3]);
          *reinterpret_cast<float4*>(KK + t * DP + d) = make_float4(kk4[0], kk4[1], kk4[2], kk4[3]);
          *reinterpret_cast<float4*>(KD + t * DP + d) = make_float4(kd4[0], kd4[1], kd4[2], kd4[3]);
        }
      }
      diag[warp * CMAX + t] = bonus;
    }
    __syncthreads();
    // 2. scores: 4 x 4 tiles of the lower triangle, four lanes a tile over
    //    quarters of D; in a diagonal tile only the entries s < t are formed.
    //    Then the bonus on the diagonal; nothing above it is ever read.
    {
      constexpr int PARTS = 4;  // lanes a tile, each over every fourth float4 of D
      const int nb = (C + 3) / 4;
      const int n_tiles = nb * (nb + 1) / 2;
      const int part = tid % PARTS;
      const unsigned group = ((1u << PARTS) - 1u) << (lane & ~(PARTS - 1));
      for (int item = tid / PARTS; item < n_tiles; item += THREADS / PARTS) {
        int ti = 0, sj = item;  // row-major index in the lower triangle -> (tile row, tile column)
        while (sj > ti) sj -= ++ti;
        const int t0 = 4 * ti, s0i = 4 * sj;
        const bool on_diag = ti == sj;
        float acc[4][4] = {};
#pragma unroll
        for (int dq = 0; dq < D / (4 * PARTS); ++dq) {
          const int d = 4 * (part + PARTS * dq);
          float4 qa[4], kb4[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            qa[a] = *reinterpret_cast<const float4*>(Q + (t0 + a) * DP + d);
            kb4[a] = *reinterpret_cast<const float4*>(KK + (s0i + a) * DP + d);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (!on_diag || c < a) {
                acc[a][c] = fmaf(qa[a].x, kb4[c].x, acc[a][c]);
                acc[a][c] = fmaf(qa[a].y, kb4[c].y, acc[a][c]);
                acc[a][c] = fmaf(qa[a].z, kb4[c].z, acc[a][c]);
                acc[a][c] = fmaf(qa[a].w, kb4[c].w, acc[a][c]);
              }
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int off = 1; off < PARTS; off <<= 1) acc[a][c] += __shfl_xor_sync(group, acc[a][c], off);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = t0 + a;
          if (a == part && t < C) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (s0i + c < t) A[t * (CMAX + 1) + s0i + c] = acc[a][c];
          }
        }
      }
      if (tid < C) {
        float bonus = 0.f;
#pragma unroll
        for (int wi = 0; wi < NWARP; ++wi) bonus += diag[wi * CMAX + tid];
        A[tid * (CMAX + 1) + tid] = bonus;
      }
    }
    __syncthreads();
    // 3. y = (r e^Lprev) S + scores v, YC neighbouring columns a thread, each
    //    summed in two halves (even and odd float4s of d, even and odd s),
    //    every row reading the chunk's old S
    {
      constexpr int YC = CMAX * EC / THREADS;  // columns a thread
      constexpr int CG = EC / YC;              // threads a row
      const int t = tid / CG;
      const int ey = YC * (tid % CG);
      if (t < C) {
        float a[YC][2] = {}, b2[YC][2] = {};
        const float* rd = RD + t * DP;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(rd + d);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < YC; ++c) {
              float& half = a[c][(d / 4) % 2];
              half = fmaf(xs[j], S[(d + j) * EC + ey + c], half);
            }
          }
        }
        const float* at = A + t * (CMAX + 1);
#pragma unroll
        for (int s = 0; s < CMAX; ++s) {  // s <= t; the entries past t are never formed, so never read
          if (s <= t) {
            const float as = at[s];
#pragma unroll
            for (int c = 0; c < YC; ++c) b2[c][s % 2] = fmaf(as, Vs[s * EC + ey + c], b2[c][s % 2]);
          }
        }
#pragma unroll
        for (int c = 0; c < YC; ++c)
          yb[(int64_t)(c0 + t) * yst + ey + c] = (a[c][0] + a[c][1]) + (b2[c][0] + b2[c][1]);
      }
    }
    // 4. S' = e^Lend S + (k e^(Lend-L))^T v into the other slice: rows
    //    d0 + 32 j of two neighbouring columns a thread
    {
      constexpr int RSTEP = THREADS / (EC / 2);
      constexpr int NR = (D + RSTEP - 1) / RSTEP;
      const int d0 = tid / (EC / 2);
      const int e = 2 * (tid % (EC / 2));
      float acc[NR][2][2] = {};  // row, column, parity of s
#pragma unroll
      for (int s = 0; s < CMAX; ++s) {
        if (s < C) {
          const float2 vse = *reinterpret_cast<const float2*>(Vs + s * EC + e);
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            const float kd = d0 + j * RSTEP < D ? KD[s * DP + d0 + j * RSTEP] : 0.f;
            acc[j][0][s % 2] = fmaf(kd, vse.x, acc[j][0][s % 2]);
            acc[j][1][s % 2] = fmaf(kd, vse.y, acc[j][1][s % 2]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int d = d0 + j * RSTEP;
        if (d < D) {
          const float2 sde = *reinterpret_cast<const float2*>(S + d * EC + e);
          *reinterpret_cast<float2*>(S_next + d * EC + e) =
              make_float2(elend[d] * sde.x + (acc[j][0][0] + acc[j][0][1]),
                          elend[d] * sde.y + (acc[j][1][0] + acc[j][1][1]));
        }
      }
    }
    float* tmp = S;
    S = S_next;
    S_next = tmp;
  }
  __syncthreads();
  for (int i = tid; i < D * EC; i += THREADS) {
    const int d = i / EC, e = i % EC;
    s_out[(int64_t)bh * D * D + d * D + e0 + e] = S[i];
  }
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u, const float* s0,
           float* y, float* s_out, int B, int T, int H, int chunk, int vec16, const int64_t* st,
           cudaStream_t stream) {
  static_assert(D % EC == 0 && D % 16 == 0, "a block owns EC whole columns; lanes take D in quarters of 4");
  static_assert(Layout<D>::BYTES <= 232448, "shared memory above the 227 KB a block can have");
  static unsigned configured = 0;  // devices whose attribute is set, one bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(configured >> dev & 1u)) {
    // above 48 KB a block's shared memory must be dynamic and opted into
    err = cudaFuncSetAttribute(rwkv6_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  rwkv6_fwd_kernel<D><<<B * H * (D / EC), THREADS, Layout<D>::BYTES, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, H, chunk, vec16, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, T, H, D) float32 with a unit stride on D; `strides` holds the
// batch, time and head strides (in elements) of r, k, v, w and y in that
// order.  u (H, D) and s0 (B, H, D, D, or null for zeros) contiguous float32;
// y (B, T, H, D) and s_out (B, H, D, D) float32, y's pointer and strides
// 8-byte aligned.  1 <= chunk <= 32 and T % chunk == 0.  vec16: 1 when the
// pointers of r, k, v and w are 16-byte aligned and their strides multiples
// of 4 (the chunks are then copied 16 bytes at a time, else 4).  Returns a
// cudaError_t (0 = launched).
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                              const void* s0, void* y, void* s_out, int B, int T, int H, int D, int chunk,
                              int vec16, const int64_t* strides, void* stream) {
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
    case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, vec16, strides, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, vec16, strides, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, vec16, strides, s);
    case 128: return launch<128>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, chunk, vec16, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
