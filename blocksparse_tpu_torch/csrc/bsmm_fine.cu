// Block-sparse matmul xprop for small blocks (b 8, 16, 32), f32, NC
// orientation (feature_axis=1), in 128-deep chunks:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (TRANS).
//
// Replaces, for f32 inputs, the TPU kernel xprop_pallas_fine
// (blocksparse_tpu/kernels/bsmm.py, body _xprop_fine_kernel; bf16 and f16
// run bsmm_fine_mma.cu on the tensor cores), which gathers Gf = 128/b LUT entries of one
// output block-row into one 128-deep MXU contraction.
//
// Plan (kernels/bsmm.py fine_plan): each output block-column's LUT entries,
// in accumulation order, cut into chunks of GF = 128/B entries.
// chunk_ptr[o]..chunk_ptr[o+1] are o's chunks; slot_in/slot_w (chunks, GF)
// hold each slot's input block-column and weight block, -1 past the end of
// the column's last chunk.
//
// Design: one thread block owns one (N-tile of TM rows, o).  Between each
// pair of barriers it stages one whole chunk, the GF x slices (TM x 128,
// transposed) and the GF W blocks (128 x B, or W^T), converted to f32, and
// runs all 128 contraction steps on a register tile of RM x RN outputs a
// thread.  bsmm_fprop.cu stages one block (B deep) a barrier pair: at b8
// that is 8 FMAs a thread between barriers, here 128 x RM x RN.  Empty
// slots stage zeros (0 * 0 leaves a sum unchanged, bit for bit).  Each
// output's f32 sum runs over the entries in LUT order, as bsmm_fprop's
// does, with the same fmaf chain from 0: the result equals bsmm_fprop.cu's
// bit for bit.  No atomics; an empty output block-column writes zeros.
//
// Bound on the H100: at the canonical small-block bench row (hidden 7680,
// b8, 105,178 blocks, N = 64) a call is 2 * N * blocks * 64 = 0.86 GFLOP
// against 14 MB (W read once); in f32 on the CUDA cores, bound by
// operations.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

constexpr int DEPTH = 128;  // contraction rows of one chunk: GF = DEPTH / B entries
constexpr int TM = 64;      // rows of N a thread block owns

// Each thread owns RM rows by RN columns of the TM x B output tile.
template <int B> struct FineTile;
template <> struct FineTile<8>  { static constexpr int RM = 4, RN = 2; };  //  64 threads
template <> struct FineTile<16> { static constexpr int RM = 4, RN = 4; };  //  64 threads
template <> struct FineTile<32> { static constexpr int RM = 4, RN = 4; };  // 128 threads

template <int B> struct FineThreads {
  static constexpr int value = (TM / FineTile<B>::RM) * (B / FineTile<B>::RN);
};

constexpr int XP = TM + 4;                      // padded row of the staged x slab
template <int B> __host__ __device__ constexpr int fine_wp() { return B + 4; }  // padded W row
template <int B> __host__ __device__ constexpr size_t fine_smem() {
  return sizeof(float) * (size_t)DEPTH * (XP + fine_wp<B>());
}

template <int R>
__device__ __forceinline__ void lds(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + r);
      v[r] = t.x; v[r + 1] = t.y; v[r + 2] = t.z; v[r + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + r);
      v[r] = t.x; v[r + 1] = t.y;
    }
  }
}

template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(FineThreads<B>::value)
bsmm_fine_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ chunk_ptr, const int* __restrict__ slot_in,
                 const int* __restrict__ slot_w, T* __restrict__ y, int N, int C,
                 int K) {
  constexpr int RM = FineTile<B>::RM, RN = FineTile<B>::RN;
  constexpr int GF = DEPTH / B;
  constexpr int TC = B / RN;
  constexpr int THREADS = FineThreads<B>::value;
  constexpr int WP = fine_wp<B>();
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [DEPTH][XP]: xs[i * B + ii][m] = x[n0 + m][in_i * B + ii]
  float* ws = smem + DEPTH * XP;  // [DEPTH][WP]: ws[i * B + ii][j] = W[w_i][ii][j] (or W^T)

  const int tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  const int n0 = blockIdx.x * TM;
  const int o = blockIdx.y;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[r][j] = 0.f;

  const int c_end = chunk_ptr[o + 1];
  for (int c = chunk_ptr[o]; c < c_end; ++c) {
    const int* cin = slot_in + (size_t)c * GF;
    const int* cw = slot_w + (size_t)c * GF;
    // x slab: along each x row the GF slices are B contiguous elements
    for (int l = tid; l < TM * DEPTH; l += THREADS) {
      const int m = l / DEPTH, kk = l % DEPTH;
      const int in = __ldg(cin + kk / B);
      const int n = n0 + m;
      xs[kk * XP + m] = (n < N && in >= 0)
          ? to_f32(x[(size_t)n * C + (size_t)in * B + kk % B]) : 0.f;
    }
    if constexpr (TRANS) {
      // ws[i * B + ii][j] = W[w_i][j][ii]: read along W's rows
      for (int l = tid; l < DEPTH * B; l += THREADS) {
        const int i = l / (B * B), rem = l % (B * B);
        const int j = rem / B, ii = rem % B;
        const int wi = __ldg(cw + i);
        ws[(i * B + ii) * WP + j] = wi >= 0 ? to_f32(w[(size_t)wi * B * B + rem]) : 0.f;
      }
    } else {
      for (int l = tid; l < DEPTH * B; l += THREADS) {
        const int i = l / (B * B), rem = l % (B * B);
        const int wi = __ldg(cw + i);
        ws[(l / B) * WP + l % B] = wi >= 0 ? to_f32(w[(size_t)wi * B * B + rem]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DEPTH; ++kk) {
      float a[RM], b[RN];
      lds<RM>(xs + kk * XP + tr * RM, a);
      lds<RN>(ws + kk * WP + tc * RN, b);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int n = n0 + tr * RM + r;
    if (n < N) {
      T* yr = y + (size_t)n * K + (size_t)o * B + tc * RN;
#pragma unroll
      for (int j = 0; j < RN; ++j) yr[j] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch_one(const void* x, const void* w, const int* chunk_ptr,
                       const int* slot_in, const int* slot_w, void* y, int N, int C, int K,
                       cudaStream_t stream) {
  auto kernel = bsmm_fine_kernel<T, B, TRANS>;
  constexpr size_t smem = fine_smem<B>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TM - 1) / TM, K / B);
  kernel<<<grid, FineThreads<B>::value, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), chunk_ptr, slot_in, slot_w,
      static_cast<T*>(y), N, C, K);
  return cudaGetLastError();
}

#define FINE_ARGS x, w, chunk_ptr, slot_in, slot_w, y, N, C, K, s

template <typename T, int B>
cudaError_t launch(int trans_w, const void* x, const void* w, const int* chunk_ptr,
                   const int* slot_in, const int* slot_w, void* y, int N, int C, int K,
                   cudaStream_t s) {
  return trans_w ? launch_one<T, B, true>(FINE_ARGS) : launch_one<T, B, false>(FINE_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w,
                     const int* chunk_ptr, const int* slot_in, const int* slot_w, void* y,
                     int N, int C, int K, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(trans_w, FINE_ARGS);
    case 16: return launch<T, 16>(trans_w, FINE_ARGS);
    case 32: return launch<T, 32>(trans_w, FINE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 (float32) only: bf16 and f16 run on the tensor cores (bsmm_fine_mma.cu);
// any other dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K);
// trans_w = 0 for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).
// bsize 8, 16 or 32.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_fine_nc(int dtype, int bsize, int trans_w, const void* x,
                            const void* w, const int* chunk_ptr, const int* slot_in,
                            const int* slot_w, void* y, int N, int C, int K,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(bsize, trans_w, FINE_ARGS);
  return cudaErrorInvalidValue;
}
