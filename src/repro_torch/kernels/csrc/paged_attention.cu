// Ragged paged-attention decode for Hopper (sm_90a), plain CUDA C++ behind a C interface.
//
// Replaces the TPU kernel `paged_attention` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py: one query token per slot attends that
// slot's KV positions 0..length-1, which live in fixed-size pages of a shared
// pool addressed through the slot's page-table row.  Pages that are
// unallocated (-1) or out of the pool, past `length`, or wholly outside the
// sliding window are skipped (the predicate of `_paged_kernel` and its
// `kv_index`).  Logit softcap, and int8 pools with per-(token, kv-head) bf16
// scales dequantised here.  An empty slot (length 0) gives 0.
//
// What bounds it on the H100: decoding reads each live K/V token once and
// does 4 * H * Dh FLOPs per token against 2 * Hkv * Dh * bytes of KV, about
// 1.5 FLOP per byte at smollm-360m's 15/5 heads in bf16, far below the ~295
// FLOP/byte where the tensor cores would become the limit.  So the bytes of
// the live pages bound it, and at a decode tick's few slots the latency of
// fetching them: the kernel must have many independent loads in flight
// across the whole card.  What the design does about that (split-KV decode):
//   - The grid is one block per (slot, kv head, split).  A split is a fixed
//     run of page-table slots (`pps` pages, about 64 tokens: 4 pages of 16);
//     the host sizes the grid from the table's width P alone, never from the
//     lengths, which live on the device.  A block whose pages lie past
//     `length` or outside the window exits at once.  At smollm's serving
//     shape (8 slots, P = 20) that is 200 blocks; at 32 slots of 2048 tokens
//     (P = 128) 5,120.
//   - All of a block's K/V bytes are requested before any math: each thread
//     starts 16-byte cp.async copies of the (tokens x Dh) K and V rows of the
//     block's kv head into shared memory, neighbouring threads on
//     neighbouring 16-byte pieces of a token's row.  Rows of a skipped page
//     are zero-filled.  int8 rows are dequantised with their scales after
//     the copy (a scale multiplies the row's dot product and its
//     probability).  A page larger than a split's staging budget is walked
//     in tiles with an online softmax.
//   - Every thread works whatever the group size G = H / Hkv: the scores are
//     (query head, token) items spread over the block's 128 threads, the
//     softmax one warp per query head, and P V (query head, dim pair) items.
//   - One launch per call, with the merge inside it.  A slot's only live
//     split writes the output itself.  Otherwise each split writes its
//     (m, l, acc[G][Dh]) in fp32 to a scratch buffer, and the last block to
//     finish a (slot, kv head) -- it learns so from an atomic ticket taken
//     with release and acquire order at device scope -- merges the live
//     splits in split order and
//     writes the output, then resets its ticket to 0, so the counter buffer
//     stays zeroed from call to call without a memset launch.  The merge
//     order is fixed, so the output is the same bit for bit from call to
//     call.  A decode tick therefore keeps one launch per layer.
//
// Masked scores are NEG_INF = -2e38 (finite) with probability 0, and the
// denominator is clamped to 1e-37.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
// the dynamic shared memory a block may ask for: the card's 232,448 bytes less room for the static `last`
constexpr int SMEM_MAX = 232448 - 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes of a pool row in shared memory, as floats
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)c[i];
}
// two neighbouring elements of a pool row in shared memory, as floats
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Dynamic shared memory of a block, in bytes from its start: the K and V
// tiles (rows padded by 16 bytes, so threads reading one 16-byte piece of
// neighbouring rows hit distinct banks; the merging block reuses them for
// every split's m and l), then fp32 q, acc and scores, the per-head m, l and
// correction, per-token scales and validity, and each token's source row.
struct Smem {
  int k, v, q, acc, s, m, l, corr, ksc, vsc, ok, src, bytes;
  __host__ __device__ Smem(int row_bytes, int G, int DH, int tile, int n_splits) {
    const int rs = row_bytes + 16;
    k = 0;
    v = k + align16(tile * rs);
    const int tiles_end = v + align16(tile * rs);
    const int merge_end = align16(2 * n_splits * G * 4);
    q = tiles_end > merge_end ? tiles_end : merge_end;
    acc = q + align16(G * DH * 4);
    s = acc + align16(G * DH * 4);
    m = s + align16(G * tile * 4);
    l = m + align16(G * 4);
    corr = l + align16(G * 4);
    ksc = corr + align16(G * 4);
    vsc = ksc + align16(tile * 4);
    ok = vsc + align16(tile * 4);
    src = ok + align16(tile * 4);
    bytes = src + tile * 8;
  }
};

// TQ: query and output type; TKV: pool type (TQ itself, or int8_t with scales).
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(NT) paged_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ pages, const int* __restrict__ lengths, TQ* __restrict__ out,
    float* __restrict__ scratch, int* __restrict__ tickets, int H, int Hkv, int n_pages_p1, int page_size, int P,
    int pps, int n_splits, int tile, int window, float softcap, float scale) {
  constexpr bool INT8 = sizeof(TKV) == 1;
  constexpr int ROW = DH * (int)sizeof(TKV);  // bytes of one token's row for one kv head
  constexpr int RS = ROW + 16;                // its padded stride in shared memory
  constexpr int PPR = ROW / 16;               // 16-byte pieces per row
  constexpr int VN = 16 / (int)sizeof(TKV);   // elements per piece
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int G = H / Hkv;
  const int split = blockIdx.x % n_splits;
  const int bh = blockIdx.x / n_splits;  // b * Hkv + hk
  const int b = bh / Hkv;
  const int hk = bh % Hkv;
  // the page-table entry of this thread's token in the split's first tile, read beside the slot's length
  const int* row = pages + (int64_t)b * P;
  const int t_first = split * pps * page_size;
  const int j_first = (t_first + tid) / page_size;
  const int pg_first = tid < tile && j_first < P ? row[j_first] : -1;
  const int length = lengths[b];
  TQ* o = out + ((int64_t)b * H + (int64_t)hk * G) * DH;

  // live page range: j * page_size < length, and (window) (j + 1) * page_size > length - window;
  // live splits: those holding a live page
  const int j_lo = window > 0 ? max(0, length - window) / page_size : 0;
  const int j_hi = min(P, (max(length, 0) + page_size - 1) / page_size);
  const int s_lo = j_lo / pps;
  const int s_hi = j_hi > j_lo ? (j_hi - 1) / pps + 1 : s_lo;
  const int n_live = s_hi - s_lo;
  if (n_live == 0) {  // an empty slot gives 0, written by its first split
    if (split == 0)
      for (int i = tid; i < G * DH; i += NT) o[i] = from_f<TQ>(0.f);
    return;
  }
  if (split < s_lo || split >= s_hi) return;

  const Smem lay(ROW, G, DH, tile, n_splits);
  unsigned char* kt = smem + lay.k;
  unsigned char* vt = smem + lay.v;
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* sc = reinterpret_cast<float*>(smem + lay.s);
  float* m_sh = reinterpret_cast<float*>(smem + lay.m);
  float* l_sh = reinterpret_cast<float*>(smem + lay.l);
  float* corr_sh = reinterpret_cast<float*>(smem + lay.corr);
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  int* ok = reinterpret_cast<int*>(smem + lay.ok);
  int64_t* src = reinterpret_cast<int64_t*>(smem + lay.src);

  const TQ* qp = q + ((int64_t)b * H + (int64_t)hk * G) * DH;
  for (int i = tid; i < G * DH; i += NT) {
    qs[i] = to_f(qp[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m_sh[g] = NEG_INF;
    l_sh[g] = 0.f;
  }
  const int pos_hi = min(min((split + 1) * pps, j_hi) * page_size, length);

  for (int t0 = t_first; t0 < pos_hi; t0 += tile) {
    const int tt = min(tile, pos_hi - t0);
    // 1. each token's source row in the pools (-1: its page is skipped, or lies before the window's
    //    first live page) and whether it is attended; a tile holds at most NT tokens
    if (tid < tt) {
      const int pos = t0 + tid;
      // an entry past the pool names the scratch page (the last) and stays live, as in the reference
      const int pg = min(t0 == t_first ? pg_first : row[pos / page_size], n_pages_p1 - 1);
      const bool live = pg >= 0 && pos >= j_lo * page_size;
      src[tid] = live ? ((int64_t)pg * page_size + pos % page_size) * Hkv + hk : -1;
      ok[tid] = live && (window <= 0 || pos > length - 1 - window);  // pos < length holds by pos_hi
    }
    __syncthreads();
    // 2. every K and V byte of the tile requested at once
    for (int i = tid; i < tt * PPR; i += NT) {
      const int t = i / PPR;
      const int c = i % PPR;
      unsigned char* kd = kt + t * RS + c * 16;
      unsigned char* vd = vt + t * RS + c * 16;
      const int64_t tok = src[t];
      if (tok >= 0) {
        cp16(kd, reinterpret_cast<const unsigned char*>(k_pool) + tok * ROW + c * 16);
        cp16(vd, reinterpret_cast<const unsigned char*>(v_pool) + tok * ROW + c * 16);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (INT8) {
      for (int t = tid; t < tt; t += NT) {
        const int64_t tok = src[t];
        ksc[t] = tok >= 0 ? __bfloat162float(k_scale[tok]) : 0.f;
        vsc[t] = tok >= 0 ? __bfloat162float(v_scale[tok]) : 0.f;
      }
    }
    cp_wait_all();
    __syncthreads();
    // 3. scores, one (query head, token) item a thread
    for (int i = tid; i < G * tt; i += NT) {
      const int g = i / tt;
      const int t = i % tt;
      float s = NEG_INF;
      if (ok[t]) {
        const float* qg = qs + g * DH;
        const unsigned char* kr = kt + t * RS;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < PPR; ++c) {
          float kf[VN];
          unpack16(kr + c * 16, kf);
#pragma unroll
          for (int e = 0; e < VN; ++e) part = fmaf(qg[c * VN + e], kf[e], part);
        }
        if constexpr (INT8) part *= ksc[t];
        s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      sc[g * tile + t] = s;
    }
    __syncthreads();
    // 4. online softmax, one warp per query head: probabilities in place of the scores
    for (int g = warp; g < G; g += NW) {
      float* sg = sc + g * tile;
      float mx = NEG_INF;
      for (int t = lane; t < tt; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_sh[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tt; t += 32) {
        const float p = ok[t] ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_sh[g] = m_new;
        l_sh[g] = l_sh[g] * corr + sum;
        corr_sh[g] = corr;
      }
    }
    __syncthreads();
    // 5. acc = acc * corr + P V, one (query head, dim pair) item a thread
    for (int i = tid; i < G * (DH / 2); i += NT) {
      const int g = i / (DH / 2);
      const int d = 2 * (i % (DH / 2));
      const float* pg = sc + g * tile;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int t = 0; t < tt; ++t) {
        float p = pg[t];
        if constexpr (INT8) p *= vsc[t];
        const float2 vv = load2(reinterpret_cast<const TKV*>(vt + t * RS) + d);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      const float corr = corr_sh[g];
      acc[g * DH + d] = acc[g * DH + d] * corr + a0;
      acc[g * DH + d + 1] = acc[g * DH + d + 1] * corr + a1;
    }
    __syncthreads();
  }

  if (n_live == 1) {  // the slot's only live split: its state is the answer
    for (int i = tid; i < G * DH; i += NT) o[i] = from_f<TQ>(acc[i] / fmaxf(l_sh[i / DH], 1e-37f));
    return;
  }
  // 6. this split's state to the scratch buffer, then a ticket: the last split of the slot merges.
  //    The barrier orders every thread's writes before thread 0's release at device scope (the
  //    atomic), and its acquire before the merging block's reads.
  const int state = G * (DH + 2);
  float* mine = scratch + ((int64_t)bh * n_splits + split) * state;
  for (int i = tid; i < G * DH; i += NT) mine[i] = acc[i];
  for (int g = tid; g < G; g += NT) {
    mine[G * DH + g] = m_sh[g];
    mine[G * DH + G + g] = l_sh[g];
  }
  __syncthreads();
  if (tid == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n" : "=r"(ticket) : "l"(tickets + bh) : "memory");
    last = ticket == n_live - 1;
    if (last) tickets[bh] = 0;  // every live split has taken its ticket: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  // 7. merge the live splits in split order (reads through L2: other blocks wrote them): every
  //    split's m and l at once into the free K/V tiles; per head m_tot (a warp each); the weights
  //    e^(m - m_tot) in parallel; per head the denominator; then acc
  const float* base = scratch + (int64_t)bh * n_splits * state;
  float* mw = reinterpret_cast<float*>(smem);  // m, then the weight, per (split, head)
  float* lw = mw + n_live * G;
  for (int i = tid; i < n_live * G; i += NT) {
    const float* st = base + (int64_t)(s_lo + i / G) * state + G * DH + i % G;
    mw[i] = __ldcg(st);
    lw[i] = __ldcg(st + G);
  }
  __syncthreads();
  for (int g = warp; g < G; g += NW) {
    float mt = NEG_INF;
    for (int s = lane; s < n_live; s += 32) mt = fmaxf(mt, mw[s * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    if (lane == 0) m_sh[g] = mt;
  }
  __syncthreads();
  for (int i = tid; i < n_live * G; i += NT) mw[i] = expf(mw[i] - m_sh[i % G]);
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    float lt = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) lt += lw[s * G + g] * mw[s * G + g];
    l_sh[g] = lt;
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH;
    const float* st = base + (int64_t)s_lo * state + i;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) a += __ldcg(st + (int64_t)s * state) * mw[s * G + g];
    o[i] = from_f<TQ>(a / fmaxf(l_sh[g], 1e-37f));
  }
}

template <typename TQ, typename TKV, int DH>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs, const int* pages,
           const int* lengths, void* out, void* scratch, int* tickets, int B, int H, int Hkv, int n_pages_p1,
           int page_size, int P, int pps, int n_splits, int tile, int window, float softcap, cudaStream_t stream) {
  const int bytes = Smem(DH * (int)sizeof(TKV), H / Hkv, DH, tile, n_splits).bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;  // devices whose attribute is set, one bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(paged_split_kernel<TQ, TKV, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  paged_split_kernel<TQ, TKV, DH><<<B * Hkv * n_splits, NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs), pages, lengths,
      static_cast<TQ*>(out), static_cast<float*>(scratch), tickets, H, Hkv, n_pages_p1, page_size, P, pps, n_splits,
      tile, window, softcap, (float)pow((double)DH, -0.5));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_dh(int Dh, const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                const int* pages, const int* lengths, void* out, void* scratch, int* tickets, int B, int H, int Hkv,
                int n_pages_p1, int page_size, int P, int pps, int n_splits, int tile, int window, float softcap,
                cudaStream_t s) {
#define PAGED_CASE(D)                                                                                            \
  case D:                                                                                                        \
    return launch<TQ, TKV, D>(q, kp, vp, ks, vs, pages, lengths, out, scratch, tickets, B, H, Hkv, n_pages_p1,  \
                              page_size, P, pps, n_splits, tile, window, softcap, s);
  switch (Dh) {
    PAGED_CASE(16)
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

}  // namespace

// q (B, H, Dh); pools (n_pages_p1, page_size, Hkv, Dh), the last page being
// scratch, each starting on a 16-byte boundary; scales (n_pages_p1,
// page_size, Hkv) bf16 for int8 pools, else null; pages (B, P) int32 with
// -1 = unallocated; lengths (B,) int32; out (B, H, Dh).  All contiguous.
// The split plan (`kernels/paged_attention.py`, `plan_splits`): pps pages a
// split, n_splits = ceil(P / pps) splits, at most `tile` tokens staged at a
// time; scratch holds B * Hkv * n_splits * G * (Dh + 2) floats, tickets
// B * Hkv ints, all 0 on entry and on return.  q_dtype: 0 float32,
// 1 bfloat16 (the output has q's type; non-int8 pools have it too).
// kv_int8: 1 for int8 pools.  window <= 0 means no window.  Returns a
// cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                                   const void* v_scale, const int* pages, const int* lengths, void* out,
                                   void* scratch, int* tickets, int q_dtype, int kv_int8, int B, int H, int Hkv,
                                   int Dh, int n_pages_p1, int page_size, int P, int pps, int n_splits, int tile,
                                   int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pps < 1 || n_splits < 1 || tile < 1 || tile > NT || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
#define PAGED_ARGS                                                                                              \
  Dh, q, k_pool, v_pool, k_scale, v_scale, pages, lengths, out, scratch, tickets, B, H, Hkv, n_pages_p1,       \
      page_size, P, pps, n_splits, tile, window, softcap, s
  if (q_dtype == 0 && !kv_int8) return dispatch_dh<float, float>(PAGED_ARGS);
  if (q_dtype == 1 && !kv_int8) return dispatch_dh<__nv_bfloat16, __nv_bfloat16>(PAGED_ARGS);
  if (q_dtype == 0 && kv_int8) return dispatch_dh<float, int8_t>(PAGED_ARGS);
  if (q_dtype == 1 && kv_int8) return dispatch_dh<__nv_bfloat16, int8_t>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
