// Fused block-sparse attention forward on Hopper's tensor cores, bf16 and
// f16:
//   out = softmax(scale * q k^T + mask) v over a block layout,
// with an online (flash-style) softmax, so the scores never leave
// registers; optionally also the per-row log-sum-exp lse = m + log(l)
// (f32), which the training backward reads.
//
// Replaces, for bf16 and f16 inputs at the sizes attn_kernel
// (kernels/bst_attn.py) leaves it (bs 16 and 32, hs 16 and 32, short key
// contexts; bst_attn_fwd_wgmma.cu takes the rest of bs 64), the TPU
// kernels fused_attention_fwd / _attn_kernel (lse == null) and
// fused_attention_fwd_lse / _attn_fwd_lse_kernel
// (blocksparse_tpu/kernels/bst_attn.py).  f32 inputs
// stay on bst_attn_fwd.cu, in full fp32 on the CUDA cores (the
// reference's f32 dots are Precision.HIGHEST, and the tensor cores would
// round them to TF32); the C interface is that source's.  It computes what
// _attn_kernel computes, entry by entry of the query block-row's CSR:
//   m' = max(m, rowmax(scale s)),  alpha = exp(m - m'),  p = exp(scale s - m'),
//   l' = l alpha + rowsum(p),      acc' = acc alpha + round(p) v,
// with l summing the unrounded p and round() the rounding to the input
// type that packing p into the PV product's A fragments does (the
// reference's p.astype(v.dtype)); then out = acc / l, rounded once.  A
// query row that sees no key gives zeros, and lse = -inf.
//
// Products: mma.sync.m16n8k16, bf16/f16 operands, f32 accumulators.  One
// thread block per (query block-row, batch*head) with BS / 16 warps (4 at
// bs 64, 2 at 32, 1 at 16); each warp owns 16 query rows.  q comes in once
// by cp.async, and each warp keeps its rows' A fragments in registers.
// The row's (k, v) block pairs stream through a ring of stages<HS>() slots
// (3, or 2 at hs 128), one barrier a slot, the next entry's index and mask
// code read one slot early into registers.  Per entry: S = q k^T over the
// whole block (k by plain ldmatrix; BS / 2 f32 registers a thread), the
// mask as a select to -inf, the row max by a quad reduction (a row's
// columns sit in the four threads of a quad), p = exp2(c s - m) with
// c = scale * log2(e) folded in (m kept in base-2 units; lse goes out in
// natural log), then acc = acc alpha + P v with P's accumulator fragments
// reused as A fragments (v by ldmatrix.trans).  Each thread keeps its own
// part of l and the quad sums it once at the end.  Every sum runs in a
// fixed order (the CSR's), with no atomics: two runs give the same bits.
// The query rows go out in CSR order or in the caller's order
// (launch_block in bst_attn.cuh).
//
// Shared-memory rows are padded by 16 bytes (bst_attn_mma.cuh); cp.async
// copies 16 bytes a thread, so q, k, v must start on 16 bytes with batch
// and row strides that are multiples of 16 bytes (the wrapper copies a
// view that is not).
//
// Work model and prediction (the LM: batch 8 x 2048, 8 heads of 64, bs 64,
// 312 blocks, e = 5.23 G multiply-adds a product), written before the
// first timed run:
// - Bound.  Two products make 20.9 GFLOP, so the bound is 0.0212 ms.
// - Memory.  k/v are re-read from L2 once per entry: 2 * 312 * 64 * 8 KB =
//   0.33 GB, about 0.08 ms at ~4 TB/s.
// - Predicted time.  At the 220-230 TFLOP/s the backward reached, the
//   kernel should take 0.08-0.15 ms, against 1.11 today and SDPA's 0.281.
// - Train step.  Device time should fall from 50.7 to about 39 ms.  The
//   step by events should fall much less, because it is host-bound: the
//   card is busy 53-56%.
// - Forward.  8 x 2048 should fall from 15.2 to about 9 ms.
// - Target.  Both entry points at or under 0.20 ms of device time in bf16
//   at the LM's shape, and below SDPA's forward in the same call.
#include <float.h>

#include "bst_attn_mma.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

struct FwdArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;
  long long qb, qr, kb, kr, vb, vr;  // q, k, v: batch and row strides
  const int *row_ptr, *ent_k, *ent_code, *order;
  const signed char* uniq;
  int batch, heads, lut_heads, ctx_blks_q;
  float scale;
};

// q, then the ring: stages<HS>() slots of (k, v).
template <typename T, int BS, int HS>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)(1 + 2 * stages<HS>()) * BS * (HS + 8) * sizeof(T);
}

template <typename T, int BS, int HS>
__global__ void __launch_bounds__(Cfg<BS>::THREADS)
bst_attn_fwd_mma_kernel(const FwdArgs a) {
  constexpr int TILE = BS * (HS + 8), ST = stages<HS>(), NT = BS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + TILE;
  __shared__ int codes[ST];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rows = a.ctx_blks_q;
  int row, bh;
  launch_block(a.order, a.batch, a.heads, a.lut_heads, rows, row, bh);
  const int b = bh / a.heads, h = bh % a.heads;
  const int* rp = a.row_ptr + (size_t)(a.lut_heads == 1 ? 0 : h) * (rows + 1);
  const int e0 = rp[row], n = rp[row + 1] - e0;
  const T* kb = static_cast<const T*>(a.k) + b * a.kb + h * HS;
  const T* vb = static_cast<const T*>(a.v) + b * a.vb + h * HS;

  auto load = [&](int kblk, int code, int slot) {
    T* ks = ring + slot * 2 * TILE;
    copy_tile<BS, HS>(ks, kb + (long long)kblk * BS * a.kr, a.kr);
    copy_tile<BS, HS>(ks + TILE, vb + (long long)kblk * BS * a.vr, a.vr);
    if (threadIdx.x == 0) codes[slot] = code;
  };
  copy_tile<BS, HS>(qs, static_cast<const T*>(a.q) + b * a.qb + (long long)row * BS * a.qr +
                            h * HS, a.qr);
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (j < n) load(a.ent_k[e0 + j], a.ent_code[e0 + j], j);
    cp_async_commit();
  }
  // the entry the next load takes, read one slot early
  int nk = 0, nc = 0;
  if (ST - 1 < n) {
    nk = a.ent_k[e0 + ST - 1];
    nc = a.ent_code[e0 + ST - 1];
  }
  cp_async_wait<ST - 2>();
  __syncthreads();
  uint32_t qa[HS / 16][4];
  load_a<HS>(qa, qs, warp * 16, lane);
  if (a.scale < 0.f)  // scale s = |scale| (-q) k^T; negating bf16/f16 is exact
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] ^= 0x80008000u;
  // scores to base-2 units; at least FLT_MIN, so that a masked -inf times c
  // stays -inf (scale 0 then gives p = 1, as it should)
  const float c = fmaxf(fabsf(a.scale), FLT_MIN) * LOG2E;

  float acc[HS / 8][4];
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  // for this thread's rows r and r + 8: the running max of c s, and this
  // thread's part of the row's sum l
  const int r = warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int s = 0; s < n; ++s) {
    if (s > 0) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // slot s landed; every warp is done with slot s - 1
    }
    if (s + ST - 1 < n) load(nk, nc, (s + ST - 1) % ST);
    cp_async_commit();
    if (s + ST < n) {
      nk = a.ent_k[e0 + s + ST];
      nc = a.ent_code[e0 + s + ST];
    }
    const T* ks = ring + (s % ST) * 2 * TILE;
    const T* vs = ks + TILE;
    const int code = codes[s % ST];

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
    mma_nt<HS, BS>(sc, qa, ks, 0, lane);
    if (code != MASK_FULL)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!visible<BS>(code, r + (i >> 1) * 8, nt * 8 + 2 * tg + (i & 1), a.uniq))
            sc[nt][i] = -INFINITY;

    float mx[2] = {-INFINITY, -INFINITY}, z[2], alpha[2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j] * c);
      // -inf while the row has seen no key: exp2(-inf - 0) = 0 makes alpha
      // and p 0 there, where -inf - (-inf) would be NaN
      z[j] = m_new == -INFINITY ? 0.f : m_new;
      alpha[j] = exp2f(m[j] - z[j]);
      m[j] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = exp2f(fmaf(sc[nt][i], c, -z[i >> 1]));  // p, unrounded
        rs[i >> 1] += sc[nt][i];
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
    for (int nt = 0; nt < HS / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
    uint32_t pa[BS / 16][4];
    to_a<BS / 16, T>(pa, sc);
    mma_nn<HS, BS / 16>(acc, pa, vs, 0, lane);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  const size_t state = (size_t)a.heads * HS, ctx_q = (size_t)rows * BS;
  T* out = static_cast<T*>(a.out) + ((size_t)b * ctx_q + (size_t)row * BS + r) * state +
           h * HS + 2 * tg;
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f, inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
#pragma unroll
  for (int nt = 0; nt < HS / 8; ++nt) {
    store2(out + nt * 8, acc[nt][0] * inv0, acc[nt][1] * inv0);
    store2(out + 8 * state + nt * 8, acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
  if (a.lse != nullptr && tg == 0) {
    float* lp = a.lse + (size_t)bh * ctx_q + (size_t)row * BS + r;
    lp[0] = l[0] > 0.f ? m[0] * LN2 + logf(l[0]) : -INFINITY;
    lp[8] = l[1] > 0.f ? m[1] * LN2 + logf(l[1]) : -INFINITY;
  }
}

template <typename T, int BS, int HS>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  auto kernel = bst_attn_fwd_mma_kernel<T, BS, HS>;
  constexpr size_t bytes = fwd_smem<T, BS, HS>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((long long)a.batch * a.heads * a.ctx_blks_q);
  kernel<<<grid, Cfg<BS>::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int BS>
cudaError_t dispatch_hs(int hs, const FwdArgs& a, cudaStream_t s) {
  switch (hs) {
    case 16: return launch<T, BS, 16>(a, s);
    case 32: return launch<T, BS, 32>(a, s);
    case 64: return launch<T, BS, 64>(a, s);
    case 128: return launch<T, BS, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int bs, int hs, const FwdArgs& a, cudaStream_t s) {
  switch (bs) {
    case 16: return dispatch_hs<T, 16>(hs, a, s);
    case 32: return dispatch_hs<T, 32>(hs, a, s);
    case 64: return dispatch_hs<T, 64>(hs, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bst_attn_fwd.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any
// other dtype returns cudaErrorInvalidValue.  q, k and v must start on 16
// bytes with batch and row strides that are multiples of 16 bytes.
// Returns a cudaError_t (0 = launched).
extern "C" int bst_attn_fwd_mma(int dtype, int bs, int hs, const void* q, const void* k,
                                const void* v, void* out, void* lse_out,
                                const long long* strides, const int* row_ptr,
                                const int* ent_k, const int* ent_code,
                                const signed char* uniq, const int* order, int batch,
                                int heads, int lut_heads, int ctx_blks_q, float scale,
                                void* stream) {
  const FwdArgs a{q, k, v, out, static_cast<float*>(lse_out),
                  strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                  row_ptr, ent_k, ent_code, order, uniq, batch, heads, lut_heads,
                  ctx_blks_q, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bs, hs, a, s);
  if (dtype == 2) return dispatch<__half>(bs, hs, a, s);
  return cudaErrorInvalidValue;
}
