// Fused block-sparse attention backward on Hopper's tensor cores, bf16 and
// f16: dq, and dk/dv, from q, k, v, dO, the forward's per-row log-sum-exp
// lse and D = rowsum(dO o O), recomputing each block's probabilities
// P = exp(scale * q k^T - lse) in registers, so neither P nor dS reaches
// shared or device memory.
//
// Replaces, for bf16 and f16 inputs, the TPU kernels fused_attention_dq /
// _attn_dq_kernel and fused_attention_dkv / _attn_dkv_kernel
// (blocksparse_tpu/kernels/bst_attn.py) at the sizes attn_kernel
// (kernels/bst_attn.py) leaves it: bst_attn_dq_wgmma.cu takes dq at bs
// 64, hs 64 and 128, bst_attn_dkv_wgmma.cu dk/dv at bs 64, hs 64; bs 16
// and 32 (and the bs-8 view) and hs 16 and 32 stay here, and dk/dv at hs
// 128.  f32 inputs stay on
// bst_attn_bwd.cu, in full fp32 on the CUDA cores (the reference's f32 dots
// are Precision.HIGHEST, and the tensor cores would round them to TF32);
// the C interface is that source's, tables and launch order included.  With
// dS = P o (dO v^T - D) * scale (P = 0 where the mask hides a key):
//   dq = round(dS) k,   dv = round(P)^T dO,   dk = round(dS)^T q,
// round() being the rounding to the input type that turning an f32
// accumulator pair into a bf16/f16 A fragment does (as the plain version
// and _attn_dq_kernel / _attn_dkv_kernel round).
//
// Products: mma.sync.m16n8k16, bf16/f16 operands, f32 accumulators.  A
// thread block has BS / 16 warps (4 at bs 64, 2 at 32, 1 at 16); each warp
// owns 16 rows of its block-row and walks the row's entries in the CSR
// order, so every sum runs in one fixed order, with no atomics: two runs
// give the same bits.
//
// dq (where attn_kernel leaves it here): one thread block per (query
// block-row, batch*head), over the nn CSR.
// q and dO come in once by cp.async, and each warp keeps the A fragments of
// its 16 rows of both in registers, with its rows' lse and D.  The row's
// key blocks come through a ring of stages<HS>() slots, one (k, v) block
// pair a slot, one barrier a slot.  Per entry, in chunks of CW key columns:
// S = q k^T and dP = dO v^T (k and v by plain ldmatrix), P and dS on the
// accumulator fragments, dS packed into A fragments in place, and
// dq += dS k (k by ldmatrix.trans).  dq is rounded once to the input type,
// or stored in f32 (which 2: ring attention sums a row's dq over the
// launches of its key chunks, as fused_attention_dq(out_dtype=f32) does).
//
// dk/dv: one thread block per (key block-row, batch*head), over the tn CSR
// whose mask codes were classified on the transposed blocks.  k and v are
// staged once (their A fragments stay in registers up to hs 64; at hs 128
// they are reloaded from shared memory each chunk, which keeps the 128 f32
// dk/dv accumulators a thread holds there out of local memory).  The ring
// brings q, dO and that query block's lse and D.  Per entry, transposed:
// S^T = k q^T and dP^T = v dO^T, P^T and dS^T with lse and D indexed by the
// column (the query), then dv += round(P^T) dO and dk += round(dS^T) q,
// A from registers and B by ldmatrix.trans.  dk and dv are stored once, in
// f32.  The key rows go out in CSR order or in the caller's order
// (launch_block in bst_attn.cuh: the rows with the most entries first).
//
// Shared-memory rows are padded by 16 bytes, so the eight row addresses of
// an ldmatrix fall in distinct banks; cp.async copies 16 bytes a thread, so
// q, k, v, dO must start on 16 bytes with batch and row strides that are
// multiples of 16 bytes (the wrapper copies a view that is not).
//
// Work model (the LM: batch 8, ctx 2048, 8 heads of 64, bs 64, 312 blocks;
// e = 312 * 8 * 8 * 64^3 = 5.23 G multiply-adds a product): dq runs 3
// products (31.4 GFLOP), dk/dv 4 (41.9 GFLOP), the bounds 0.032 and 0.042
// ms at 989 TFLOP/s.  k/v (q/dO) are re-read from L2 once per entry,
// 2 * 312 * 64 * 8 KB = 0.33 GB a kernel, about 0.09 ms at ~4 TB/s.  The
// mma.sync rate binds, and below it shared memory: each warp reads every
// B operand of its entry through ldmatrix (dq 24 KB, dk/dv 32 KB a warp
// an entry).  At the 90-150 TFLOP/s of the tensor-core xprop kernel the
// prediction is dq 0.21-0.35 ms, dk/dv 0.28-0.47 ms.
#include "bst_attn_mma.cuh"

namespace {

// exp(scale s - lse) where the mask shows (r, c), else 0 (a select: with
// lse = -inf the exp is +inf).
template <int BS>
__device__ __forceinline__ float prob(int code, int r, int c, const signed char* uniq, float s,
                                      float scale, float lse) {
  return visible<BS>(code, r, c, uniq) ? exp2f(fmaf(s, scale, -lse) * LOG2E) : 0.f;
}

template <typename T, int BS, int HS>
__host__ __device__ constexpr size_t dq_smem() {
  return (size_t)(2 + 2 * stages<HS>()) * BS * (HS + 8) * sizeof(T);
}

// O: dq's type, T (which 0) or float (which 2, for a caller that sums dq
// over several launches).
template <typename T, int BS, int HS, typename O>
__global__ void __launch_bounds__(Cfg<BS>::THREADS)
bst_attn_dq_mma_kernel(const Args a, O* __restrict__ dq) {
  constexpr int TILE = BS * (HS + 8), ST = stages<HS>(), CW = Cfg<BS>::CW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + TILE;
  T* ring = dos + TILE;  // ST slots of (k, v)
  __shared__ int codes[ST];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rows = a.ctx_blks_q;
  const int row = blockIdx.x % rows, bh = blockIdx.x / rows;
  const int b = bh / a.heads, h = bh % a.heads;
  const int* rp = a.row_ptr + (size_t)(a.lut_heads == 1 ? 0 : h) * (rows + 1);
  const int e0 = rp[row], n = rp[row + 1] - e0;
  const int ctx_q = rows * BS;
  const Strides& st = a.st;
  const T* kb = static_cast<const T*>(a.k) + b * st.kb + h * HS;
  const T* vb = static_cast<const T*>(a.v) + b * st.vb + h * HS;

  auto load = [&](int kblk, int code, int slot) {
    T* ks = ring + slot * 2 * TILE;
    copy_tile<BS, HS>(ks, kb + (long long)kblk * BS * st.kr, st.kr);
    copy_tile<BS, HS>(ks + TILE, vb + (long long)kblk * BS * st.vr, st.vr);
    if (threadIdx.x == 0) codes[slot] = code;
  };
  copy_tile<BS, HS>(qs, static_cast<const T*>(a.q) + b * st.qb + (long long)row * BS * st.qr +
                            h * HS, st.qr);
  copy_tile<BS, HS>(dos, static_cast<const T*>(a.dout) + b * st.ob +
                             (long long)row * BS * st.orow + h * HS, st.orow);
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < n) load(a.ent[e0 + j], a.ent_code[e0 + j], j);
    cp_async_commit();
  }
  // the entry the next load takes, read one slot early
  int nk = 0, nc = 0;
  if (ST - 1 < n) {
    nk = a.ent[e0 + ST - 1];
    nc = a.ent_code[e0 + ST - 1];
  }
  // this thread's accumulator rows: r and r + 8
  const int r = warp * 16 + g;
  const size_t lr = (size_t)bh * ctx_q + (size_t)row * BS + r;
  const float lse0 = a.lse[lr], lse1 = a.lse[lr + 8];
  const float d0 = a.dvec[lr], d1 = a.dvec[lr + 8];
  const float scale = a.scale;
  cp_async_wait<ST - 2>();
  __syncthreads();
  uint32_t qa[HS / 16][4], oa[HS / 16][4];
  load_a<HS>(qa, qs, warp * 16, lane);
  load_a<HS>(oa, dos, warp * 16, lane);

  float acc[HS / 8][4];
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int s = 0; s < n; ++s) {
    if (s > 0) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // slot s landed; every warp is done with slot s - 1
    }
    if (s + ST - 1 < n) load(nk, nc, (s + ST - 1) % ST);
    cp_async_commit();
    if (s + ST < n) {
      nk = a.ent[e0 + s + ST];
      nc = a.ent_code[e0 + s + ST];
    }
    const T* ks = ring + (s % ST) * 2 * TILE;
    const T* vs = ks + TILE;
    const int code = codes[s % ST];
#pragma unroll
    for (int c0 = 0; c0 < BS; c0 += CW) {
      float sc[CW / 8][4], dp[CW / 8][4];
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
      mma_nt<HS, CW>(sc, qa, ks, c0, lane);
      mma_nt<HS, CW>(dp, oa, vs, c0, lane);
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = r + (i >> 1) * 8, cc = c0 + nt * 8 + 2 * tg + (i & 1);
          const float p = prob<BS>(code, rr, cc, a.uniq, sc[nt][i], scale, i < 2 ? lse0 : lse1);
          sc[nt][i] = p * (dp[nt][i] - (i < 2 ? d0 : d1)) * scale;  // dS
        }
      uint32_t da[CW / 16][4];
      to_a<CW / 16, T>(da, sc);
      mma_nn<HS, CW / 16>(acc, da, ks, c0, lane);
    }
  }

  const size_t state = (size_t)a.heads * HS;
  O* out = dq + ((size_t)b * ctx_q + (size_t)row * BS + r) * state + h * HS + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt) {
    store2(out + nt * 8, acc[nt][0], acc[nt][1]);
    store2(out + 8 * state + nt * 8, acc[nt][2], acc[nt][3]);
  }
}

// k and v, then the ring: ST slots of (q, dO, lse, D).
template <typename T, int BS, int HS>
__host__ __device__ constexpr size_t dkv_slot() {
  return 2 * (size_t)BS * (HS + 8) * sizeof(T) + 2 * BS * sizeof(float);
}
template <typename T, int BS, int HS>
__host__ __device__ constexpr size_t dkv_smem() {
  return 2 * (size_t)BS * (HS + 8) * sizeof(T) + stages<HS>() * dkv_slot<T, BS, HS>();
}

template <typename T, int BS, int HS>
__global__ void __launch_bounds__(Cfg<BS>::THREADS)
bst_attn_dkv_mma_kernel(const Args a, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int TILE = BS * (HS + 8), ST = stages<HS>(), CW = Cfg<BS>::CW;
  constexpr size_t SLOT = dkv_slot<T, BS, HS>();
  constexpr bool RESIDENT = HS <= 64;  // k, v A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + TILE;
  unsigned char* ring = smem + 2 * TILE * sizeof(T);
  __shared__ int codes[ST];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rows = a.ctx_blks_k;
  int krow, bh;
  launch_block(a.order, a.batch, a.heads, a.lut_heads, rows, krow, bh);
  const int b = bh / a.heads, h = bh % a.heads;
  const int* rp = a.row_ptr + (size_t)(a.lut_heads == 1 ? 0 : h) * (rows + 1);
  const int e0 = rp[krow], n = rp[krow + 1] - e0;
  const int ctx_q = a.ctx_blks_q * BS;
  const Strides& st = a.st;
  const T* qb = static_cast<const T*>(a.q) + b * st.qb + h * HS;
  const T* ob = static_cast<const T*>(a.dout) + b * st.ob + h * HS;
  const float* lb = a.lse + (size_t)bh * ctx_q;
  const float* db = a.dvec + (size_t)bh * ctx_q;

  auto load = [&](int qblk, int code, int slot) {
    T* qs = reinterpret_cast<T*>(ring + slot * SLOT);
    T* os = qs + TILE;
    float* ls = reinterpret_cast<float*>(os + TILE);
    copy_tile<BS, HS>(qs, qb + (long long)qblk * BS * st.qr, st.qr);
    copy_tile<BS, HS>(os, ob + (long long)qblk * BS * st.orow, st.orow);
    // lse then D: BS / 4 chunks of 16 bytes each
    if (threadIdx.x < BS / 2) {
      const int j = threadIdx.x % (BS / 4) * 4;
      const float* src = (threadIdx.x < BS / 4 ? lb : db) + (size_t)qblk * BS + j;
      cp_async16(smem_addr(ls + (threadIdx.x < BS / 4 ? 0 : BS) + j), src, true);
    }
    if (threadIdx.x == 0) codes[slot] = code;
  };
  copy_tile<BS, HS>(ks, static_cast<const T*>(a.k) + b * st.kb + (long long)krow * BS * st.kr +
                            h * HS, st.kr);
  copy_tile<BS, HS>(vs, static_cast<const T*>(a.v) + b * st.vb + (long long)krow * BS * st.vr +
                            h * HS, st.vr);
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < n) load(a.ent[e0 + j], a.ent_code[e0 + j], j);
    cp_async_commit();
  }
  int nq = 0, nc = 0;
  if (ST - 1 < n) {
    nq = a.ent[e0 + ST - 1];
    nc = a.ent_code[e0 + ST - 1];
  }
  const int r = warp * 16 + g;  // this thread's key rows: r and r + 8
  const float scale = a.scale;
  cp_async_wait<ST - 2>();
  __syncthreads();
  uint32_t ka[RESIDENT ? HS / 16 : 1][4], va[RESIDENT ? HS / 16 : 1][4];
  if constexpr (RESIDENT) {
    load_a<HS>(ka, ks, warp * 16, lane);
    load_a<HS>(va, vs, warp * 16, lane);
  }

  float dka[HS / 8][4], dva[HS / 8][4];
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  for (int s = 0; s < n; ++s) {
    if (s > 0) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // slot s landed; every warp is done with slot s - 1
    }
    if (s + ST - 1 < n) load(nq, nc, (s + ST - 1) % ST);
    cp_async_commit();
    if (s + ST < n) {
      nq = a.ent[e0 + s + ST];
      nc = a.ent_code[e0 + s + ST];
    }
    const T* qs = reinterpret_cast<const T*>(ring + (s % ST) * SLOT);
    const T* os = qs + TILE;
    const float* ls = reinterpret_cast<const float*>(os + TILE);
    const float* dsv = ls + BS;
    const int code = codes[s % ST];
#pragma unroll
    for (int c0 = 0; c0 < BS; c0 += CW) {
      float sc[CW / 8][4], dp[CW / 8][4];
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = dp[nt][i] = 0.f;
      if constexpr (RESIDENT) {
        mma_nt<HS, CW>(sc, ka, qs, c0, lane);
        mma_nt<HS, CW>(dp, va, os, c0, lane);
      } else {
        uint32_t fa[HS / 16][4];
        load_a<HS>(fa, ks, warp * 16, lane);
        mma_nt<HS, CW>(sc, fa, qs, c0, lane);
        load_a<HS>(fa, vs, warp * 16, lane);
        mma_nt<HS, CW>(dp, fa, os, c0, lane);
      }
#pragma unroll
      for (int nt = 0; nt < CW / 8; ++nt) {
        const int cc = c0 + nt * 8 + 2 * tg;  // the query columns cc, cc + 1
        const float2 l2 = *reinterpret_cast<const float2*>(ls + cc);
        const float2 d2 = *reinterpret_cast<const float2*>(dsv + cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = prob<BS>(code, r + (i >> 1) * 8, cc + (i & 1), a.uniq, sc[nt][i],
                                   scale, i & 1 ? l2.y : l2.x);
          sc[nt][i] = p;                                                  // P^T
          dp[nt][i] = p * (dp[nt][i] - (i & 1 ? d2.y : d2.x)) * scale;  // dS^T
        }
      }
      uint32_t pa[CW / 16][4], sa[CW / 16][4];
      to_a<CW / 16, T>(pa, sc);
      to_a<CW / 16, T>(sa, dp);
      mma_nn<HS, CW / 16>(dva, pa, os, c0, lane);
      mma_nn<HS, CW / 16>(dka, sa, qs, c0, lane);
    }
  }

  const size_t state = (size_t)a.heads * HS;
  const size_t off = ((size_t)b * rows * BS + (size_t)krow * BS + r) * state + h * HS + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt) {
    store2(dk + off + nt * 8, dka[nt][0], dka[nt][1]);
    store2(dk + off + 8 * state + nt * 8, dka[nt][2], dka[nt][3]);
    store2(dv + off + nt * 8, dva[nt][0], dva[nt][1]);
    store2(dv + off + 8 * state + nt * 8, dva[nt][2], dva[nt][3]);
  }
}

template <typename T, int BS, int HS, typename O>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  auto kernel = bst_attn_dq_mma_kernel<T, BS, HS, O>;
  constexpr size_t bytes = dq_smem<T, BS, HS>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((long long)a.batch * a.heads * a.ctx_blks_q);
  kernel<<<grid, Cfg<BS>::THREADS, bytes, stream>>>(a, static_cast<O*>(dq));
  return cudaGetLastError();
}

template <typename T, int BS, int HS>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  auto kernel = bst_attn_dkv_mma_kernel<T, BS, HS>;
  constexpr size_t bytes = dkv_smem<T, BS, HS>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((long long)a.batch * a.heads * a.ctx_blks_k);
  kernel<<<grid, Cfg<BS>::THREADS, bytes, stream>>>(a, static_cast<float*>(dk),
                                                     static_cast<float*>(dv));
  return cudaGetLastError();
}

template <typename T, int BS>
cudaError_t dispatch_hs(int hs, int which, const Args& a, void* o0, void* o1,
                        cudaStream_t s) {
#define BWD_HS(HS)                                                   \
  case HS:                                                           \
    return which == 0   ? launch_dq<T, BS, HS, T>(a, o0, s)          \
           : which == 2 ? launch_dq<T, BS, HS, float>(a, o0, s)      \
                        : launch_dkv<T, BS, HS>(a, o0, o1, s);
  switch (hs) {
    BWD_HS(16)
    BWD_HS(32)
    BWD_HS(64)
    BWD_HS(128)
    default: return cudaErrorInvalidValue;
  }
#undef BWD_HS
}

template <typename T>
cudaError_t dispatch(int bs, int hs, int which, const Args& a, void* o0, void* o1,
                     cudaStream_t s) {
  switch (bs) {
    case 16: return dispatch_hs<T, 16>(hs, which, a, o0, o1, s);
    case 32: return dispatch_hs<T, 32>(hs, which, a, o0, o1, s);
    case 64: return dispatch_hs<T, 64>(hs, which, a, o0, o1, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bst_attn_bwd.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any
// other dtype returns cudaErrorInvalidValue; which 2 is dq stored in f32.
// q, k, v and dO must start on 16 bytes with batch and row strides that are
// multiples of 16 bytes, lse and D on 16 bytes.  Returns a cudaError_t (0 = launched).
extern "C" int bst_attn_bwd_mma(int dtype, int which, int bs, int hs, const void* q,
                                const void* k, const void* v, const void* dout,
                                const void* lse, const void* dvec, void* out0, void* out1,
                                const long long* strides, const int* row_ptr, const int* ent,
                                const int* ent_code, const signed char* uniq,
                                const int* order, int batch, int heads, int lut_heads,
                                int ctx_blks_q, int ctx_blks_k, float scale, void* stream) {
  if (which < 0 || which > 2) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, dvec, strides, row_ptr, ent, ent_code,
                           order, uniq, batch, heads, lut_heads, ctx_blks_q, ctx_blks_k,
                           scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bs, hs, which, a, out0, out1, s);
  if (dtype == 2) return dispatch<__half>(bs, hs, which, a, out0, out1, s);
  return cudaErrorInvalidValue;
}
