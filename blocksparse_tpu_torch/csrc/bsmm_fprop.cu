// Block-sparse matmul xprop in the NC orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w).
//
// Replaces both directions of the TPU kernels xprop_pallas_dense_tile,
// xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py).  All three compute this product; the
// TPU picks among them for its MXU tiling.
//
// LUT: a CSR over output block-columns o.  Entries row_ptr[o]..row_ptr[o+1]
// hold (ent_in, ent_w): input block-column and weight block, sorted as
// BlocksparseMatMul sorts fprop_list (fprop: o = k, in = c) or bprop_list
// (bprop: o = c, in = k), so the f32 sum runs in a fixed order.
//
// Design: one thread block owns one (N-tile of TM rows, o).  It walks o's
// entries; for each it stages x[n-tile, in*B:(in+1)*B] (transposed) and W[w]
// (or W[w]^T) in shared memory, KC contraction rows at a time, converted to
// f32, and accumulates a register tile of RM x RN outputs per thread.  It
// writes y[n-tile, o*B:(o+1)*B] once.  No atomics; an empty output row
// writes zeros.  f32 inputs run in full fp32 on the CUDA cores (no TF32),
// bf16 and f16 inputs accumulate in f32 and round once on the store.
//
// Split route (PARTIAL, a template flag like TRANS, so the unflagged kernels
// are unchanged): row_ptr is then the CSR over partial tiles, each a run of
// consecutive entries of one output block-column, and the kernel writes each
// tile's f32 sum unrounded into a (N, tiles * B) f32 array.  bsmm_merge.cu
// adds a column's tiles in phase order and rounds once.
//
// Bound on the H100: at the training shapes (N = 8*2048) each call is
// ~2*N*blocks*B^2 = 18 GFLOP against ~100 MB of traffic, so it is bound by
// operations; this first version uses the CUDA cores, not the tensor cores
// (wgmma is later work).  At decode (N = batch) it is bound by the bytes of
// W, which it reads exactly once per call.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Output tile per block: TM rows of N by the B columns of one block-column;
// each thread owns RM rows by RN columns.
template <int B> struct Tile;
template <> struct Tile<8>   { static constexpr int TM = 64,  RM = 4, RN = 2; };
template <> struct Tile<16>  { static constexpr int TM = 128, RM = 4, RN = 4; };
template <> struct Tile<32>  { static constexpr int TM = 128, RM = 4, RN = 4; };
template <> struct Tile<64>  { static constexpr int TM = 128, RM = 8, RN = 4; };
template <> struct Tile<128> { static constexpr int TM = 64,  RM = 4, RN = 8; };

template <int B> struct Threads {
  static constexpr int value = (Tile<B>::TM / Tile<B>::RM) * (B / Tile<B>::RN);
};

// TRANS (bprop) stages W[w]^T; its W tile is padded (a multiple of 4 keeps
// the float4 reads aligned) so the transposing stores spread over banks.
// PARTIAL writes the f32 sums (TO = float) instead of rounding to T.
template <typename T, int B, bool TRANS, bool PARTIAL,
          typename TO = std::conditional_t<PARTIAL, float, T>>
__global__ void __launch_bounds__(Threads<B>::value)
bsmm_xprop_nc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ row_ptr, const int* __restrict__ ent_in,
                     const int* __restrict__ ent_w, TO* __restrict__ y,
                     int N, int C, int K) {
  constexpr int TM = Tile<B>::TM, RM = Tile<B>::RM, RN = Tile<B>::RN;
  constexpr int TC = B / RN;
  constexpr int THREADS = Threads<B>::value;
  constexpr int KC = B < 32 ? B : 32;  // contraction rows staged at a time
  constexpr int XP = TM + 4;           // padded row of the transposed x tile
  constexpr int WP = TRANS ? B + 4 : B;  // W row
  __shared__ __align__(16) float xs[KC][XP];
  __shared__ __align__(16) float ws[KC][WP];

  const int tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  const int n0 = blockIdx.x * TM;
  const int o = blockIdx.y;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[r][j] = 0.f;

  const int e_end = row_ptr[o + 1];
  for (int e = row_ptr[o]; e < e_end; ++e) {
    const T* xb = x + (size_t)ent_in[e] * B;
    const T* wb = w + (size_t)ent_w[e] * B * B;
    for (int i0 = 0; i0 < B; i0 += KC) {
      for (int l = tid; l < TM * KC; l += THREADS) {
        const int m = l / KC, ii = l % KC;
        const int n = n0 + m;
        xs[ii][m] = n < N ? to_f32(xb[(size_t)n * C + i0 + ii]) : 0.f;
      }
      if constexpr (TRANS) {
        // ws[ii][j] = W[j][i0 + ii]: read along W's rows (coalesced)
        for (int l = tid; l < KC * B; l += THREADS) {
          const int j = l / KC, ii = l % KC;
          ws[ii][j] = to_f32(wb[(size_t)j * B + i0 + ii]);
        }
      } else {
        for (int l = tid; l < KC * B; l += THREADS)
          ws[l / B][l % B] = to_f32(wb[(size_t)i0 * B + l]);
      }
      __syncthreads();
#pragma unroll 8
      for (int ii = 0; ii < KC; ++ii) {
        float a[RM], b[RN];
#pragma unroll
        for (int r = 0; r < RM; r += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&xs[ii][tr * RM + r]);
          a[r] = t.x; a[r + 1] = t.y; a[r + 2] = t.z; a[r + 3] = t.w;
        }
        if constexpr (RN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < RN; j += 4) {
            const float4 t = *reinterpret_cast<const float4*>(&ws[ii][tc * RN + j]);
            b[j] = t.x; b[j + 1] = t.y; b[j + 2] = t.z; b[j + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < RN; ++j) b[j] = ws[ii][tc * RN + j];
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int n = n0 + tr * RM + r;
    if (n < N) {
      TO* yr = y + (size_t)n * K + (size_t)o * B + tc * RN;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        if constexpr (PARTIAL) yr[j] = acc[r][j];
        else yr[j] = from_f32<T>(acc[r][j]);
      }
    }
  }
}

template <typename T, int B, bool PARTIAL>
cudaError_t launch(const void* x, const void* w, const int* row_ptr, const int* ent_in,
                   const int* ent_w, void* y, int N, int C, int K, int trans_w,
                   cudaStream_t stream) {
  using TO = std::conditional_t<PARTIAL, float, T>;
  constexpr int TM = Tile<B>::TM;
  dim3 grid((N + TM - 1) / TM, K / B);
  auto kernel = trans_w ? bsmm_xprop_nc_kernel<T, B, true, PARTIAL>
                        : bsmm_xprop_nc_kernel<T, B, false, PARTIAL>;
  kernel<<<grid, Threads<B>::value, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), row_ptr, ent_in, ent_w,
      static_cast<TO*>(y), N, C, K);
  return cudaGetLastError();
}

#define XPROP_ARGS x, w, row_ptr, ent_in, ent_w, y, N, C, K, trans_w, s

template <typename T, bool PARTIAL>
cudaError_t dispatch(int bsize, const void* x, const void* w, const int* row_ptr,
                     const int* ent_in, const int* ent_w, void* y, int N, int C, int K,
                     int trans_w, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8, PARTIAL>(XPROP_ARGS);
    case 16: return launch<T, 16, PARTIAL>(XPROP_ARGS);
    case 32: return launch<T, 32, PARTIAL>(XPROP_ARGS);
    case 64: return launch<T, 64, PARTIAL>(XPROP_ARGS);
    case 128: return launch<T, 128, PARTIAL>(XPROP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PARTIAL>
int xprop_nc(int dtype, int bsize, int trans_w, const void* x, const void* w,
             const int* row_ptr, const int* ent_in, const int* ent_w, void* y, int N,
             int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, PARTIAL>(bsize, XPROP_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16, PARTIAL>(bsize, XPROP_ARGS);
  if (dtype == 2) return dispatch<__half, PARTIAL>(bsize, XPROP_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x is (N, C), y (N, K);
// trans_w = 0 for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).
// Returns a cudaError_t (0 = launched).
extern "C" int bsmm_xprop_nc(int dtype, int bsize, int trans_w, const void* x,
                             const void* w, const int* row_ptr, const int* ent_in,
                             const int* ent_w, void* y, int N, int C, int K, void* stream) {
  return xprop_nc<false>(dtype, bsize, trans_w, x, w, row_ptr, ent_in, ent_w, y, N, C,
                         K, stream);
}

// The split route's partial tiles: the same product over the tile CSR
// (tile_ptr), y an f32 (N, tiles * bsize) array whatever the input dtype.
extern "C" int bsmm_xprop_nc_partials(int dtype, int bsize, int trans_w, const void* x,
                                      const void* w, const int* tile_ptr,
                                      const int* ent_in, const int* ent_w, void* y,
                                      int N, int C, int K, void* stream) {
  return xprop_nc<true>(dtype, bsize, trans_w, x, w, tile_ptr, ent_in, ent_w, y, N, C,
                        K, stream);
}
