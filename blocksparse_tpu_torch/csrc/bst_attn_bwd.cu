// Fused block-sparse attention backward in f32, flash style: dq, and dk/dv,
// from q, k, v, dO, the forward's per-row log-sum-exp lse and
// D = rowsum(dO o O), recomputing each block's probabilities
// P = exp(scale * q k^T - lse) so no score tensor reaches device memory.
//
// Replaces, for f32 inputs, the TPU kernels fused_attention_dq /
// _attn_dq_kernel and fused_attention_dkv / _attn_dkv_kernel
// (blocksparse_tpu/kernels/bst_attn.py).  bf16 and f16 run
// bst_attn_bwd_mma.cu on the tensor cores, through the same C interface;
// f32 stays here in full fp32 on the CUDA cores (the reference's f32 dots
// are Precision.HIGHEST, which the tensor cores would round to TF32), and
// this source refuses any other dtype.  D is computed outside, in plain
// torch, as fused_attention_bwd does.
//
// dq: one thread block (256 threads) per (query block-row, batch*head),
// walking the row's key blocks in the nn CSR of the forward:
//   dP = dO v^T;  dS = P o (dP - D) * scale;  dq += round(dS) k,
// with dS rounded to k's type before the product, as _attn_dq_kernel does.
// dq is stored once, in the input type.
//
// dkv: one thread block per (key block-row, batch*head), walking the key
// row's query blocks in the tn CSR, whose mask codes were classified on the
// TRANSPOSED mask blocks (TRIL and TRIU swap, unique blocks transposed):
//   P^T, dP^T = v dO^T;  dv += round(P^T) dO;  dk += round(dS^T) q,
// with P rounded to dO's type and dS to q's, as _attn_dkv_kernel does (in
// f32 a no-op).  dk and dv accumulate in f32 registers and are stored once
// in f32.  The key rows go out in CSR order, or in the caller's order
// (launch_block, bst_attn.cuh).
//
// Every sum runs in a fixed order (the CSR order), with no atomics.  A
// query row that sees no key (lse = -inf, F1) gets P = 0: zero dq and no
// contribution to dk/dv.
//
// Layout: q, k, v, dO are (batch, ctx, heads*HS) with the last dim
// contiguous and their own batch and row strides; lse and D are contiguous
// (batch, heads, ctx_q) f32; dq is a contiguous (batch, ctx_q, heads*HS) of
// the input type, dk and dv contiguous (batch, ctx_k, heads*HS) f32.
//
// Bound on the H100: per (row, block) each kernel does 4 products of
// BS*BS*HS FMAs against 2*BS*HS elements read (mostly from L2), so the
// CUDA-core f32 FMA rate bounds it.
#include <cuda_runtime.h>
#include <math.h>

#include "bst_attn.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v) { return v; }

// v as a product with an operand of type T sees it: rounded to T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int THREADS = 256;

// Stage a (BS, HS) block of a (batch, ctx, heads*HS) tensor in f32.
template <typename T, int BS, int HS>
__device__ __forceinline__ void stage(float (*dst)[HS + 1], const T* __restrict__ src,
                                      long long row_stride) {
  for (int l = threadIdx.x; l < BS * HS; l += THREADS)
    dst[l / HS][l % HS] = to_f32(src[(l / HS) * row_stride + l % HS]);
}

template <int BS, int HS>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BS * (HS + 1) + BS * (BS + 1) + 2 * BS);
}

template <typename T, int BS, int HS>
__global__ void __launch_bounds__(THREADS)
bst_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ dvec, T* __restrict__ dq, Strides st,
                   const int* __restrict__ row_ptr, const int* __restrict__ ent_k,
                   const int* __restrict__ ent_code, const signed char* __restrict__ uniq,
                   int heads, int lut_heads, int ctx_blks_q, float scale) {
  constexpr int RB = BS / 16, DB = HS / 16;
  extern __shared__ __align__(16) float smem[];
  float(*qs)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem);
  float(*dos)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + BS * (HS + 1));
  float(*ks)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + 2 * BS * (HS + 1));
  float(*vs)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + 3 * BS * (HS + 1));
  float(*ss)[BS + 1] = reinterpret_cast<float(*)[BS + 1]>(smem + 4 * BS * (HS + 1));
  float* lse_s = smem + 4 * BS * (HS + 1) + BS * (BS + 1);
  float* d_s = lse_s + BS;

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int row = blockIdx.x % ctx_blks_q;
  const int bh = blockIdx.x / ctx_blks_q;
  const int b = bh / heads, h = bh % heads;
  const int* rp = row_ptr + (size_t)(lut_heads == 1 ? 0 : h) * (ctx_blks_q + 1);
  const int ctx_q = ctx_blks_q * BS;

  stage<T, BS, HS>(qs, q + b * st.qb + (long long)row * BS * st.qr + h * HS, st.qr);
  stage<T, BS, HS>(dos, dout + b * st.ob + (long long)row * BS * st.orow + h * HS, st.orow);
  for (int r = tid; r < BS; r += THREADS) {
    lse_s[r] = lse[(size_t)bh * ctx_q + (size_t)row * BS + r];
    d_s[r] = dvec[(size_t)bh * ctx_q + (size_t)row * BS + r];
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
    stage<T, BS, HS>(ks, k + b * st.kb + (long long)kblk * BS * st.kr + h * HS, st.kr);
    stage<T, BS, HS>(vs, v + b * st.vb + (long long)kblk * BS * st.vr + h * HS, st.vr);
    __syncthreads();

    {
      float s[RB][RB], dp[RB][RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HS; ++d) {
        float a[RB], o[RB], kk[RB], vv[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          a[i] = qs[ti + 16 * i][d];
          o[i] = dos[ti + 16 * i][d];
          kk[i] = ks[tj + 16 * i][d];
          vv[i] = vs[tj + 16 * i][d];
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            s[i][j] = fmaf(a[i], kk[j], s[i][j]);
            dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = ti + 16 * i;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int c = tj + 16 * j;
          const float p = visible<BS>(code, r, c, uniq) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ss[r][c] = round_to<T>(p * (dp[i][j] - d_s[r]) * scale);
        }
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BS; ++c) {
      float ds[RB], kk[DB];
#pragma unroll
      for (int i = 0; i < RB; ++i) ds[i] = ss[ti + 16 * i][c];
#pragma unroll
      for (int d = 0; d < DB; ++d) kk[d] = ks[c][tj + 16 * d];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int d = 0; d < DB; ++d) acc[i][d] = fmaf(ds[i], kk[d], acc[i][d]);
    }
    __syncthreads();
  }

  const int state = heads * HS;
  T* op = dq + ((size_t)b * ctx_q + (size_t)row * BS) * state + h * HS;
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int d = 0; d < DB; ++d)
      op[(size_t)(ti + 16 * i) * state + tj + 16 * d] = from_f32<T>(acc[i][d]);
}

template <int BS, int HS>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * BS * (HS + 1) + 2 * BS * (BS + 1) + 2 * BS);
}

template <typename T, int BS, int HS>
__global__ void __launch_bounds__(THREADS)
bst_attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dk,
                    float* __restrict__ dv, Strides st, const int* __restrict__ row_ptr,
                    const int* __restrict__ ent_q, const int* __restrict__ ent_code,
                    const signed char* __restrict__ uniq, const int* __restrict__ order,
                    int batch, int heads, int lut_heads, int ctx_blks_q, int ctx_blks_k,
                    float scale) {
  constexpr int RB = BS / 16, DB = HS / 16;
  extern __shared__ __align__(16) float smem[];
  float(*ks)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem);
  float(*vs)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + BS * (HS + 1));
  float(*qs)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + 2 * BS * (HS + 1));
  float(*dos)[HS + 1] = reinterpret_cast<float(*)[HS + 1]>(smem + 3 * BS * (HS + 1));
  float(*pt)[BS + 1] = reinterpret_cast<float(*)[BS + 1]>(smem + 4 * BS * (HS + 1));
  float(*dst)[BS + 1] =
      reinterpret_cast<float(*)[BS + 1]>(smem + 4 * BS * (HS + 1) + BS * (BS + 1));
  float* lse_s = smem + 4 * BS * (HS + 1) + 2 * BS * (BS + 1);
  float* d_s = lse_s + BS;

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  int krow, bh;
  launch_block(order, batch, heads, lut_heads, ctx_blks_k, krow, bh);
  const int b = bh / heads, h = bh % heads;
  const int* rp = row_ptr + (size_t)(lut_heads == 1 ? 0 : h) * (ctx_blks_k + 1);
  const int ctx_q = ctx_blks_q * BS;

  stage<T, BS, HS>(ks, k + b * st.kb + (long long)krow * BS * st.kr + h * HS, st.kr);
  stage<T, BS, HS>(vs, v + b * st.vb + (long long)krow * BS * st.vr + h * HS, st.vr);
  float dk_acc[RB][DB], dv_acc[RB][DB];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int d = 0; d < DB; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  const int e_end = rp[krow + 1];
  for (int e = rp[krow]; e < e_end; ++e) {
    const int qblk = ent_q[e];
    const int code = ent_code[e];
    stage<T, BS, HS>(qs, q + b * st.qb + (long long)qblk * BS * st.qr + h * HS, st.qr);
    stage<T, BS, HS>(dos, dout + b * st.ob + (long long)qblk * BS * st.orow + h * HS,
                     st.orow);
    for (int c = tid; c < BS; c += THREADS) {
      lse_s[c] = lse[(size_t)bh * ctx_q + (size_t)qblk * BS + c];
      d_s[c] = dvec[(size_t)bh * ctx_q + (size_t)qblk * BS + c];
    }
    __syncthreads();

    {
      // transposed scores: rows r are keys, columns c are queries
      float s[RB][RB], dp[RB][RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HS; ++d) {
        float kk[RB], vv[RB], a[RB], o[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          kk[i] = ks[ti + 16 * i][d];
          vv[i] = vs[ti + 16 * i][d];
          a[i] = qs[tj + 16 * i][d];
          o[i] = dos[tj + 16 * i][d];
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], o[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = ti + 16 * i;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int c = tj + 16 * j;
          const float p = visible<BS>(code, r, c, uniq) ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          pt[r][c] = round_to<T>(p);
          dst[r][c] = round_to<T>(p * (dp[i][j] - d_s[c]) * scale);
        }
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      float p[RB], ds[RB], o[DB], a[DB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        p[i] = pt[ti + 16 * i][c];
        ds[i] = dst[ti + 16 * i][c];
      }
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        o[d] = dos[c][tj + 16 * d];
        a[d] = qs[c][tj + 16 * d];
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int d = 0; d < DB; ++d) {
          dv_acc[i][d] = fmaf(p[i], o[d], dv_acc[i][d]);
          dk_acc[i][d] = fmaf(ds[i], a[d], dk_acc[i][d]);
        }
    }
    __syncthreads();
  }

  const int state = heads * HS;
  const size_t base = ((size_t)b * ctx_blks_k * BS + (size_t)krow * BS) * state + h * HS;
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      const size_t off = base + (size_t)(ti + 16 * i) * state + tj + 16 * d;
      dk[off] = dk_acc[i][d];
      dv[off] = dv_acc[i][d];
    }
}

template <typename T, int BS, int HS>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<BS, HS>();
  auto kern = bst_attn_dq_kernel<T, BS, HS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)a.batch * a.heads * a.ctx_blks_q;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(dq), a.st, a.row_ptr,
      a.ent, a.ent_code, a.uniq, a.heads, a.lut_heads, a.ctx_blks_q, a.scale);
  return cudaGetLastError();
}

template <typename T, int BS, int HS>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<BS, HS>();
  auto kern = bst_attn_dkv_kernel<T, BS, HS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)a.batch * a.heads * a.ctx_blks_k;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, dk, dv, a.st, a.row_ptr, a.ent,
      a.ent_code, a.uniq, a.order, a.batch, a.heads, a.lut_heads, a.ctx_blks_q,
      a.ctx_blks_k, a.scale);
  return cudaGetLastError();
}

// which = 0 or 2: dq into out0 (T is float here, so both store f32); which
// = 1: dk, dv into out0, out1.
template <typename T, int BS, int HS>
cudaError_t launch(int which, const Args& a, void* out0, void* out1, cudaStream_t s) {
  if (which != 1) return launch_dq<T, BS, HS>(a, out0, s);
  return launch_dkv<T, BS, HS>(a, static_cast<float*>(out0), static_cast<float*>(out1), s);
}

template <typename T, int BS>
cudaError_t dispatch_hs(int hs, int which, const Args& a, void* o0, void* o1,
                        cudaStream_t s) {
  switch (hs) {
    case 16: return launch<T, BS, 16>(which, a, o0, o1, s);
    case 32: return launch<T, BS, 32>(which, a, o0, o1, s);
    case 64: return launch<T, BS, 64>(which, a, o0, o1, s);
    case 128: return launch<T, BS, 128>(which, a, o0, o1, s);
    default: return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32 (bf16 and f16 run bst_attn_bwd_mma.cu, with this
// interface; here they return cudaErrorInvalidValue).
// which: 0 = dq (row_ptr/ent/ent_code: the nn CSR over query block-rows;
// out0: dq, input type); 2 = dq in f32 (as 0 here, where the input type
// is f32); 1 = dk/dv (the tn CSR over key block-rows with transposed mask
// codes and table; out0, out1: dk, dv in f32).
// strides: batch and row strides, in elements, of q, k, v and dO.
// order: null (CSR order) or, for dk/dv, (lut_heads, ctx_blks_k) int32, the
// key block-rows in launch order (launch_block).
// Returns a cudaError_t (0 = launched).
extern "C" int bst_attn_bwd(int dtype, int which, int bs, int hs, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* out0, void* out1,
                            const long long* strides, const int* row_ptr, const int* ent,
                            const int* ent_code, const signed char* uniq,
                            const int* order, int batch, int heads, int lut_heads,
                            int ctx_blks_q, int ctx_blks_k, float scale, void* stream) {
  if (dtype != 0 || which < 0 || which > 2) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, dvec, strides, row_ptr, ent, ent_code,
                           order, uniq, batch, heads, lut_heads, ctx_blks_q, ctx_blks_k,
                           scale);
  return dispatch<float>(bs, hs, which, a, out0, out1, static_cast<cudaStream_t>(stream));
}
