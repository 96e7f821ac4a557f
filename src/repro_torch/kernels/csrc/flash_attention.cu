// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: causal and sliding-window GQA
// attention with online softmax (fp32 running max m, denominator l and
// accumulator), logit softcap and a query offset, skipping key tiles that the
// causal mask or the window leaves unreachable.  Masked scores take
// probability 0 and the denominator is clamped to 1e-37, so a row with no key
// to attend gives 0, never NaN.  Ragged edges (Sq, Sk not multiples of the
// tiles) are masked here, not asserted.  Query head h reads KV head h / G for
// any group size G.
//
// What bounds it on the H100: at smollm-360m's serving shape (one prompt of
// 256 tokens, 15 query heads over 5 KV heads, head_dim 64, bf16) the call
// moves about 1.3 MB and does 0.13 GFLOP of products, so the bound is the
// bytes (0.39 us at 3.35 TB/s); by a prompt of about 2048 tokens the causal
// products (8.06 GFLOP) take longer than the bytes at the tensor cores' 989
// TFLOP/s, and the bound is the operations (8.1 us).
//
// The bf16 route, `flash_fwd_wgmma`: what the design does about that.
//   - One warpgroup (128 threads) per 64-row query tile of one query head:
//     60 blocks at smollm's 256 tokens, the longest (diagonal) tiles first.
//   - Both products on the tensor cores with wgmma.mma_async and fp32
//     accumulators in registers: S = Q K^T as m64n64k16 with Q (64 x Dh) and
//     the key tile (64 x Dh) in shared memory, both K-major; O += P V with P
//     taken from registers (the fp32 score fragment is rounded to bf16 and
//     packed into A fragments in place, the accumulator and A layouts
//     coincide) and V's tile read from shared memory as a transposed
//     (MN-major) B operand, N = Dh in products of at most 64 columns.  THIS
//     IS WHERE THE bf16 ROUTE ROUNDS: P goes to bf16 before P V, as SDPA and
//     FlashAttention do; m, l, the scores and the accumulator stay fp32.
//   - Shared-memory tiles swizzled as wgmma reads them: rows of min(Dh, 64)
//     bf16 (32, 64 or 128 bytes, the 32B/64B/128B swizzle modes), a head dim
//     above 64 in blocks of 64 columns; the tiles are 1024-byte aligned.
//   - K and V tiles land by cp.async (16 bytes a copy, zero-filled past Sk)
//     in a two-stage ring: tile t + 1 is in flight while tile t is
//     multiplied; Q is loaded once, with the first tile.
//   - Softmax on the accumulator fragments: a thread holds two rows of the
//     tile, so row max and row sum reduce over the 4 threads of a quad;
//     ex2.approx with the scale folded into log2(e) (4096 exponentials a
//     tile on the special-function units: at head dim 64 they take a tile
//     about as long as its products on the tensor cores); the causal,
//     window and Sk masks only on tiles that reach an edge; the row sum
//     stays per thread until the end.
//   - The epilogue divides by the row sum and writes bf16 pairs from the
//     registers.
// The float32 route, `flash_fwd_f32`, is the first version (fp32 FMA on the
// CUDA cores): its 2e-5 tolerance rules out TF32, and serving runs in bf16.
// One block of 128 threads per (q tile, batch * query head); a query row is
// owned by LANES = DH / 16 neighbouring threads, each holding 16 of its head
// dims; each block stages one K and one V tile in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int THREADS = 128;
constexpr int DPT = 16;     // head dims held by one thread (float32 route)
constexpr int KCHUNK = 16;  // keys scored per online-softmax update (float32 route)

// ---------------------------------------------------------------------------
// float32 route: fp32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
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
  const float* qp = q + b * qsb + (int64_t)min(qi, Sq - 1) * qss + h * qsh;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qp[i * LANES + lane];
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

  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  for (int t = t_begin; t < t_end; ++t) {
    const int kbase = t * BK;
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH;
      const int d = idx % DH;
      const int kp = kbase + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = kb[(int64_t)kp * kss + d];
        vv = vb[(int64_t)kp * vss + d];
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
    float* op = o + b * osb + (int64_t)qi * oss + h * osh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * LANES + lane] = acc[i] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 64;  // query rows of a block (one wgmma M)
constexpr int BK = 64;  // keys of a tile (the N of S = Q K^T)
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of a 64-row bf16 tile of head dim DH.
template <int DH>
struct Geo {
  static constexpr int RB = DH >= 64 ? 128 : DH * 2;  // bytes of a row in one column block
  static constexpr int TILE = 64 * DH * 2;             // bytes of a tile
  static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // the descriptor's 128B/64B/32B swizzle
  static constexpr uint32_t SWZ = RB / 16 - 1;         // row bits XORed into the 16-byte chunk index
  static constexpr uint32_t SBO = 8 * RB / 16;         // 8-row group stride, in 16-byte units
  static constexpr int NW = DH >= 64 ? 64 : DH;        // columns of one P V product
  static constexpr int NB = DH / NW;                   // P V products per k step
};

// Byte offset in a tile of 16-byte chunk `cg` (of DH / 8) of row r: column
// blocks of 64 rows x RB bytes, the chunk index XORed with the row bits as
// the swizzle mode does it in hardware (Swizzle<log2(RB/16), 4, 3>).
template <int DH>
__device__ __forceinline__ uint32_t tile_off(int r, int cg) {
  using G = Geo<DH>;
  constexpr int CPR = G::RB / 16;
  const uint32_t o = (uint32_t)((cg / CPR) * (64 * G::RB) + r * G::RB + (cg % CPR) * 16);
  return o ^ (((o >> 7) & G::SWZ) << 4);
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         ((uint64_t)layout << 62);
}

// K-major operand (Q or a key tile): the 16 columns of k step kk.
template <int DH>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using G = Geo<DH>;
  constexpr int COLS = G::RB / 2;  // columns of one column block
  const uint32_t a = tile + (kk * 16 / COLS) * (64 * G::RB) + (kk * 16 % COLS) * 2;
  return desc(a, 1, G::SBO, G::LAYOUT);
}

// MN-major operand (a value tile): keys 16 kk .. 16 kk + 15, columns 64 nb ...
// One product never spans two swizzle atoms along N, so the leading offset
// is not read; it is set to the 8-row stride as well.
template <int DH>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk, int nb) {
  using G = Geo<DH>;
  const uint32_t a = tile + nb * (64 * G::RB) + kk * 16 * G::RB;
  return desc(a, G::SBO, G::SBO, G::LAYOUT);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keep the compiler from moving register reads or writes across an async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// Make this thread's copies into shared memory visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of a (rows x DH) matrix with row stride rs
// (elements) into a swizzled tile; rows at or past `nrows` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base, int64_t rs, int row0,
                                          int nrows) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CH / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int r = idx / CH, cg = idx % CH;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* src = ok ? base + (int64_t)(row0 + r) * rs + cg * 8 : base;
    cp16(dst + tile_off<DH>(r, cg), src, ok);
  }
}

// 2^x by the special-function unit, subnormal results flushed to 0: a
// probability below 2^-126 of its row's largest is 0 here, beside a sum of at least 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// D (64 x 64, fp32 in registers) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major).
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, fp32 in registers) += A (64 x 16, bf16 in registers) * B (16 x 16, shared, MN-major).
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32 in registers) += A (64 x 16, bf16 in registers) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32 in registers) += A (64 x 16, bf16 in registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NW>
__device__ __forceinline__ void mma_pv(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NW == 16) mma_rs_n16(d, a, db);
  else if constexpr (NW == 32) mma_rs_n32(d, a, db);
  else mma_rs_n64(d, a, db);
}

}  // namespace wg

// Fragment layout of a 64 x N fp32 accumulator (and of S): thread
// (warp w, lane l) holds rows r0 = 16 w + l / 4 and r0 + 8; element i is in
// row r0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (l % 4) + (i & 1).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int Hkv,
    int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh,
    int causal, int window, float softcap, int q_offset, float scale) {
  using G = wg::Geo<DH>;
  constexpr int NW = G::NW, NB = G::NB;
  extern __shared__ uint8_t smem[];
  // tiles: Q, then K stage 0 and 1, then V stage 0 and 1, from a 1024-byte boundary
  const uint32_t s_q = ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * wg::BQ;  // the longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = (lane % 4) * 2;        // its first column in each group of 8

  // Key range this q tile can reach; tiles outside it are skipped whole.
  const int first_q = q_offset + q0;
  const int last_q = q_offset + min(q0 + wg::BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, last_q + 1) : Sk;
  const int k_begin = window > 0 ? max(0, first_q - window + 1) : 0;
  const int t_begin = k_begin / wg::BK;
  const int t_end = k_end > k_begin ? (k_end + wg::BK - 1) / wg::BK : t_begin;

  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  if (t_begin < t_end) {
    wg::load_tile<DH>(s_q, q + b * qsb + h * qsh, qss, q0, Sq);
    wg::load_tile<DH>(s_q + G::TILE, kb, kss, t_begin * wg::BK, Sk);
    wg::load_tile<DH>(s_q + 3 * G::TILE, vb, vss, t_begin * wg::BK, Sk);
    wg::cp_commit();
    if (t_begin + 1 < t_end) {
      wg::load_tile<DH>(s_q + 2 * G::TILE, kb, kss, (t_begin + 1) * wg::BK, Sk);
      wg::load_tile<DH>(s_q + 4 * G::TILE, vb, vss, (t_begin + 1) * wg::BK, Sk);
    }
    wg::cp_commit();
  }

  const bool capped = softcap > 0.f;
  const float sl2 = scale * wg::LOG2E;  // logits to log2 units
  float acc[NB][NW / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[nb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of each row, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of each row's sum

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    const uint32_t s_k = s_q + (1 + st) * G::TILE;
    const uint32_t s_v = s_q + (3 + st) * G::TILE;
    wg::cp_wait_prev();  // this thread's copies of tile t (and of Q) have landed
    wg::fence_async_shared();
    __syncthreads();

    float s[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_kmajor<DH>(s_q, kk), wg::desc_kmajor<DH>(s_k, kk), kk > 0);
    wg::commit();
    wg::wait_all();
    wg::fence_regs(s);

    // scores to log2 units, masked where the tile reaches an edge
    const int kbase = t * wg::BK;
    const bool edge = (causal && kbase + wg::BK - 1 > first_q) ||
                      (window > 0 && kbase <= q_offset + q0 + wg::BQ - 1 - window) || kbase + wg::BK > Sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = capped ? softcap * tanhf(s[i] * scale / softcap) * wg::LOG2E : s[i] * sl2;
      if (edge) {
        const int kp = kbase + 8 * (i >> 2) + c0 + (i & 1);
        const int qp = first_q + r0 + 8 * ((i >> 1) & 1);
        const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2], base[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      base[j] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: every p is 0
      corr[j] = wg::ex2(m[j] - base[j]);
      m[j] = m_new;
      l[j] *= corr[j];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = wg::ex2(s[i] - base[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[nb][i] *= corr[(i >> 1) & 1];
    // P to bf16 A fragments, one per 16 keys: the accumulator's layout is the A layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = wg::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wg::mma_pv<NW>(acc[nb], pa[kk], wg::desc_mnmajor<DH>(s_v, kk, nb));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wg::fence_regs(acc[nb]);

    __syncthreads();  // every thread is done with this stage: refill it with tile t + 2
    if (t + 2 < t_end) {
      wg::load_tile<DH>(s_k, kb, kss, (t + 2) * wg::BK, Sk);
      wg::load_tile<DH>(s_v, vb, vss, (t + 2) * wg::BK, Sk);
    }
    wg::cp_commit();
  }

  // the row sums over the quad, then O / l in bf16 pairs
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = 1.f / fmaxf(l[j], 1e-37f);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    if (qi >= Sq) continue;
    __nv_bfloat16* op = o + b * osb + (int64_t)qi * oss + h * osh;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int g = 0; g < NW / 8; ++g) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(acc[nb][4 * g + 2 * j] * l[j], acc[nb][4 * g + 2 * j + 1] * l[j]);
        *reinterpret_cast<__nv_bfloat162*>(op + nb * 64 + 8 * g + c0) = pr;
      }
  }
}

template <int DH>
void launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int Hkv,
                const int64_t* st, int causal, int window, float softcap, int q_offset, float scale,
                cudaStream_t stream) {
  constexpr int ROWS = THREADS / (DH / DPT);
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  flash_fwd_f32<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, softcap, q_offset, scale);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int Hkv,
                const int64_t* st, int causal, int window, float softcap, int q_offset, float scale,
                cudaStream_t stream) {
  constexpr int SMEM = 5 * wg::Geo<DH>::TILE + 1024;  // Q, two K and two V tiles, and room to align
  static unsigned configured = 0;                      // devices whose attribute is set, one bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const dim3 grid((Sq + wg::BQ - 1) / wg::BQ, B * H);
  flash_fwd_wgmma<DH><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window, softcap, q_offset, scale);
  return 0;
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H, int Hkv,
           const int64_t* st, int causal, int window, float softcap, int q_offset, cudaStream_t stream) {
  const float scale = (float)pow((double)DH, -0.5);
  if (dtype == 0) {
    launch_f32<DH>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, scale, stream);
  } else {
    const int err = launch_bf16<DH>(q, k, v, o, B, Sq, Sk, H, Hkv, st, causal, window, softcap, q_offset, scale,
                                    stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), o (B, Sq, H, Dh), each with a unit
// stride on the last axis; `strides` holds the batch, sequence and head
// strides (in elements) of q, k, v and o in that order.  dtype: 0 float32,
// 1 bfloat16 (all four tensors alike; for bfloat16 every pointer 16-byte
// aligned and every stride a multiple of 8).  window <= 0 means no window.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int Hkv, int Dh, const int64_t* strides, int causal,
                                   int window, float softcap, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch<16>(dtype, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
    case 32: return launch<32>(dtype, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, B, Sq, Sk, H, Hkv, strides, causal, window, softcap, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
