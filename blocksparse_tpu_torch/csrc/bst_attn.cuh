// What the block-sparse attention's sources share: the forward's
// (bst_attn_fwd.cu, f32 on the CUDA cores; bst_attn_fwd_mma.cu and
// bst_attn_fwd_wgmma.cu, bf16/f16 on the tensor cores) and the backward's
// (bst_attn_bwd.cu, f32; bst_attn_bwd_mma.cu, bst_attn_dq_wgmma.cu and
// bst_attn_dkv_wgmma.cu, bf16/f16): the per-entry mask codes, the backward's strides and tables
// of the C interface, the launch order of a kernel's block-rows, and the
// wgmma kernels' work items over the pair plan.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MASK_ABSENT = 0, MASK_FULL = 1, MASK_TRIL = 2, MASK_TRIU = 3, MASK_UNIQ0 = 4;

// Whether row r of a block sees column c under the entry's mask code: all,
// the lower or upper triangle, or a row-major (BS, BS) int8 block of the
// unique table.  A select, never a multiply: a query row that sees no key
// has lse = -inf, and exp(s - lse) is then +inf.
template <int BS>
__device__ __forceinline__ bool visible(int code, int r, int c,
                                        const signed char* __restrict__ uniq) {
  if (code == MASK_FULL) return true;
  if (code == MASK_TRIL) return r >= c;
  if (code == MASK_TRIU) return r <= c;
  return uniq[((size_t)(code - MASK_UNIQ0) * BS + r) * BS + c] != 0;
}

// 2^x by the SFU alone, for the wgmma kernels' probabilities (a denormal
// result flushes to 0: a p below 2^-126 changes no sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Strides {
  long long qb, qr, kb, kr, vb, vr, ob, orow;  // q, k, v, dO: batch and row
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dvec;
  Strides st;
  const int *row_ptr, *ent, *ent_code, *order;
  const signed char* uniq;
  int batch, heads, lut_heads, ctx_blks_q, ctx_blks_k;
  float scale;
};

// The (block-row, batch*head) a thread block owns: the query block-rows of
// the forward, the key block-rows of dk/dv.  Without an order the row runs
// fastest (CSR order); with one, blocks go out by rank, batch*head fastest,
// and order[lut_head][rank] names the row, so the rows with the most
// entries start first and the last wave is short.
__device__ __forceinline__ void launch_block(const int* __restrict__ order, int batch,
                                             int heads, int lut_heads, int rows, int& row,
                                             int& bh) {
  if (order == nullptr) {
    row = blockIdx.x % rows;
    bh = blockIdx.x / rows;
  } else {
    const int n_bh = batch * heads;
    bh = blockIdx.x % n_bh;
    const int lh = lut_heads == 1 ? 0 : bh % heads;
    row = order[(size_t)lh * rows + blockIdx.x / n_bh];
  }
}

// A wgmma kernel's work item over the pair plan (pair_plan in
// kernels/bst_attn.py): item i is the pair of rank i / (batch * heads) of
// batch * head i % (batch * heads), so the pairs with the longest unions
// go first; its two block-rows (row[1] = -1 past an odd last row) and its
// union entries e0 .. e1 of the plan's (block, mask, code_a, code_b).
struct PairItem {
  int b, h, bh, row[2], e0, e1;
};
__device__ __forceinline__ PairItem pair_item(int item, const int* __restrict__ pair_rows,
                                              const int* __restrict__ pair_ptr, int batch,
                                              int heads, int lut_heads, int pairs) {
  const int n_bh = batch * heads, rank = item / n_bh, bh = item % n_bh, h = bh % heads;
  const size_t lh = lut_heads == 1 ? 0 : h;
  const int* pr = pair_rows + (lh * pairs + rank) * 2;
  const int* pp = pair_ptr + lh * (pairs + 1) + rank;
  return PairItem{bh / heads, h, bh, {__ldg(pr), __ldg(pr + 1)}, __ldg(pp), __ldg(pp + 1)};
}

inline Args make_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dvec, const long long* s,
                      const int* row_ptr, const int* ent, const int* ent_code,
                      const int* order, const signed char* uniq, int batch, int heads,
                      int lut_heads, int ctx_blks_q, int ctx_blks_k, float scale) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
              Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]},
              row_ptr, ent, ent_code, order, uniq, batch, heads, lut_heads, ctx_blks_q,
              ctx_blks_k, scale};
}

}  // namespace
