// Fused block-sparse attention forward in f32, on the CUDA cores:
//   out = softmax(scale * q k^T + mask) v over a block layout,
// with an online (flash-style) softmax, so the score tensor never reaches
// device memory; optionally also the per-row log-sum-exp
//   lse = m + log(l)  (f32), which the training backward reads.
//
// Replaces, for f32 inputs, the TPU kernels fused_attention_fwd /
// _attn_kernel (lse == null) and fused_attention_fwd_lse /
// _attn_fwd_lse_kernel (blocksparse_tpu/kernels/bst_attn.py).  bf16 and
// f16 inputs run bst_attn_fwd_mma.cu on the tensor cores, through this
// interface; here they return cudaErrorInvalidValue.  f32 stays in full
// fp32 on the CUDA cores: the reference's f32 dots are Precision.HIGHEST,
// and the tensor cores would round them to TF32.  The TPU's q-row pairing,
// lane folding, K/V residency-vs-streaming choice and schedule packing are
// TPU mechanics and are not carried over.
//
// LUT, per layout head: a CSR over query block-rows.  Entries
// row_ptr[r]..row_ptr[r+1] (offsets into the flat entry arrays) hold the
// key block ent_k and its mask code ent_code (bst_attn.cuh): 1 FULL, 2
// TRIL (q >= k inside the block), 3 TRIU (q <= k), >= 4 an index code-4
// into the table `uniq` of (BS, BS) int8 blocks.  Codes and order are
// those of classify_mask_blocks and nn_list.
//
// Layout: q, k, v are (batch, ctx, heads*HS) with the last dim contiguous;
// the kernel takes each tensor's batch and row strides itself, so q/k/v can
// be the column slices of one packed qkv tensor with no copy.  out is a
// contiguous (batch, ctx, heads*HS); lse, when given, a contiguous
// (batch, heads, ctx) f32.
//
// Design: one thread block (256 threads) owns one (query block-row,
// batch*head); the block-rows go out in CSR order or in the caller's order
// (launch_block, bst_attn.cuh).  It keeps the q block in shared memory and
// streams the row's k/v blocks: S = scale * q k^T, the mask, then a
// per-row online softmax update (running max m, sum l, rescale alpha) by
// one warp per row, and acc = acc * alpha + p v in registers.  It writes
// acc / l once.  A query row that sees no key (fully masked) is defined to
// output zeros, with lse = -inf.
//
// Bound on the H100: per (row, key block) it moves 2*BS*HS elements for
// 4*BS*BS*HS flops, so K/V traffic (served largely from L2: every row of a
// head rereads the same keys) and the f32 FMA rate both matter.
#include <math.h>

#include "bst_attn.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int BS, int HS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BS * (HS + 1) + BS * HS + BS * (BS + 1) + 3 * BS);
}

template <int BS, int HS>
__global__ void __launch_bounds__(THREADS)
bst_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, long long qb, long long qr, long long kb, long long kr,
                    long long vb, long long vr,
                    const int* __restrict__ row_ptr, const int* __restrict__ ent_k,
                    const int* __restrict__ ent_code, const signed char* __restrict__ uniq,
                    const int* __restrict__ order, int batch, int heads, int lut_heads,
                    int ctx_blks_q, float scale) {
  constexpr int RB = BS / 16;  // rows (and score columns) per thread
  constexpr int DB = HS / 16;  // head dims per thread
  extern __shared__ __align__(16) float smem[];
  float(*qs)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem);
  float(*ks)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + BS * (HS + 1));
  float(*vs)[HS] = reinterpret_cast<float(*)[HS]>(smem + 2 * BS * (HS + 1));
  float(*ss)[BS + 1] = reinterpret_cast<float(*)[BS + 1]>(smem + 2 * BS * (HS + 1) + BS * HS);
  float* m_s = smem + 2 * BS * (HS + 1) + BS * HS + BS * (BS + 1);
  float* l_s = m_s + BS;
  float* a_s = l_s + BS;

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  int row, bh;
  launch_block(order, batch, heads, lut_heads, ctx_blks_q, row, bh);
  const int b = bh / heads, h = bh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int* rp = row_ptr + (size_t)lh * (ctx_blks_q + 1);

  const float* qp = q + b * qb + (long long)row * BS * qr + h * HS;
  for (int l = tid; l < BS * HS; l += THREADS) qs[l / HS][l % HS] = qp[(l / HS) * qr + l % HS];
  for (int r = tid; r < BS; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[RB][DB];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int d = 0; d < DB; ++d) acc[i][d] = 0.f;

  const int e_end = rp[row + 1];
  for (int e = rp[row]; e < e_end; ++e) {
    const int kblk = ent_k[e];
    const int code = ent_code[e];
    const float* kp = k + b * kb + (long long)kblk * BS * kr + h * HS;
    const float* vp = v + b * vb + (long long)kblk * BS * vr + h * HS;
    for (int l = tid; l < BS * HS; l += THREADS) {
      ks[l / HS][l % HS] = kp[(l / HS) * kr + l % HS];
      vs[l / HS][l % HS] = vp[(l / HS) * vr + l % HS];
    }
    __syncthreads();

    // scores, masked to -inf
    {
      float s[RB][RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HS; ++d) {
        float a[RB], c[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) a[i] = qs[ti + 16 * i][d];
#pragma unroll
        for (int j = 0; j < RB; ++j) c[j] = ks[tj + 16 * j][d];
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < RB; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = ti + 16 * i;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int c = tj + 16 * j;
          ss[r][c] = visible<BS>(code, r, c, uniq) ? s[i][j] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int r = warp; r < BS; r += WARPS) {
      float mx = -INFINITY;
      for (int c = lane; c < BS; c += 32) mx = fmaxf(mx, ss[r][c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      float alpha = 1.f;
      if (m_new == -INFINITY) {  // nothing visible in this row yet
        for (int c = lane; c < BS; c += 32) ss[r][c] = 0.f;
      } else {
        alpha = expf(m_old - m_new);  // 0 while m_old is -inf
        for (int c = lane; c < BS; c += 32) {
          const float p = expf(ss[r][c] - m_new);
          sum += p;
          ss[r][c] = p;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float al = a_s[ti + 16 * i];
#pragma unroll
      for (int d = 0; d < DB; ++d) acc[i][d] *= al;
    }
#pragma unroll 8
    for (int c = 0; c < BS; ++c) {
      float p[RB], vv[DB];
#pragma unroll
      for (int i = 0; i < RB; ++i) p[i] = ss[ti + 16 * i][c];
#pragma unroll
      for (int d = 0; d < DB; ++d) vv[d] = vs[c][tj + 16 * d];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int d = 0; d < DB; ++d) acc[i][d] = fmaf(p[i], vv[d], acc[i][d]);
    }
    __syncthreads();
  }
  __syncthreads();  // l_s complete even for a row with no entries

  const int ctx_q = ctx_blks_q * BS;
  const int state = heads * HS;
  float* op = out + ((size_t)b * ctx_q + (size_t)row * BS) * state + h * HS;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = ti + 16 * i;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < DB; ++d)
      op[(size_t)r * state + tj + 16 * d] = acc[i][d] * inv;
  }
  if (lse != nullptr)
    for (int r = tid; r < BS; r += THREADS)
      lse[(size_t)bh * ctx_q + (size_t)row * BS + r] =
          l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : -INFINITY;
}

template <int BS, int HS>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse,
                   const long long* strides, const int* row_ptr, const int* ent_k,
                   const int* ent_code, const signed char* uniq, const int* order, int batch,
                   int heads, int lut_heads, int ctx_blks_q, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BS, HS>();
  auto kern = bst_attn_fwd_kernel<BS, HS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)batch * heads * ctx_blks_q;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      q, k, v, out, lse, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], row_ptr, ent_k, ent_code, uniq, order, batch, heads, lut_heads, ctx_blks_q,
      scale);
  return cudaGetLastError();
}

#define BST_ARGS q, k, v, out, lse, strides, row_ptr, ent_k, ent_code, uniq, order, batch, \
                 heads, lut_heads, ctx_blks_q, scale, s

template <int BS>
cudaError_t dispatch_hs(int hs, const float* q, const float* k, const float* v, float* out,
                        float* lse, const long long* strides, const int* row_ptr,
                        const int* ent_k, const int* ent_code, const signed char* uniq,
                        const int* order, int batch, int heads, int lut_heads,
                        int ctx_blks_q, float scale, cudaStream_t s) {
  switch (hs) {
    case 16: return launch<BS, 16>(BST_ARGS);
    case 32: return launch<BS, 32>(BST_ARGS);
    case 64: return launch<BS, 64>(BST_ARGS);
    case 128: return launch<BS, 128>(BST_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (bf16 and f16 run bst_attn_fwd_mma.cu, with this
// interface; here they return cudaErrorInvalidValue).  strides: batch and
// row strides, in elements, of q, k and v (qb, qr, kb, kr, vb, vr).  lse:
// null (serving forward) or a (batch, heads, ctx_q) f32 output (training
// forward).  order: null (CSR order) or (lut_heads, ctx_blks_q) int32, the
// query block-rows in launch order (launch_block).  Returns a cudaError_t
// (0 = launched).
extern "C" int bst_attn_fwd(int dtype, int bs, int hs, const void* q_in, const void* k_in,
                            const void* v_in, void* out_in, void* lse_out,
                            const long long* strides, const int* row_ptr, const int* ent_k,
                            const int* ent_code, const signed char* uniq, const int* order,
                            int batch, int heads, int lut_heads, int ctx_blks_q, float scale,
                            void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(q_in);
  const float* k = static_cast<const float*>(k_in);
  const float* v = static_cast<const float*>(v_in);
  float* out = static_cast<float*>(out_in);
  float* lse = static_cast<float*>(lse_out);
  switch (bs) {
    case 16: return dispatch_hs<16>(hs, BST_ARGS);
    case 32: return dispatch_hs<32>(hs, BST_ARGS);
    case 64: return dispatch_hs<64>(hs, BST_ARGS);
    default: return cudaErrorInvalidValue;
  }
}
