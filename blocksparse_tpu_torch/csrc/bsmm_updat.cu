// Block-sparse matmul weight gradient (updat) in the NC orientation:
//   dw[e] (B, B) = x[:, c_e*B:(c_e+1)*B]^T . dy[:, k_e*B:(k_e+1)*B],
// summed over the N rows, for every layout block e, in f32.
//
// Replaces the TPU kernel updat_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) and, for canonical (blocks, B, B)
// weights, updat_pallas_grouped and updat_pallas, which compute the same
// dw with other MXU tilings.
//
// LUT: (ent_c, ent_k) per block id e, the layout's updat_list.
//
// Design: one thread block owns one layout block e.  It walks all N rows in
// tiles of TN: stages x[tile, c_e block] and dy[tile, k_e block] in shared
// memory as f32 and accumulates the B x B tile in registers (RI x RJ per
// thread), then writes it once.  The sum order is fixed: no atomics.  Each
// thread issues its staging loads up to 8 at a time before storing them;
// left to itself the compiler may pair every load with its store, and the
// kernel then runs ~10% slower at B = 32.
//
// Bound on the H100: at the training shapes (N = 8*2048, 558 blocks of 32)
// a call is 2*N*blocks*B^2 = 18.7 GFLOP against ~70 MB of reads, so it is
// bound by operations; like the xprop kernel it runs on the CUDA cores
// (tensor cores are later work).  One block per layout block gives ~4
// blocks per SM there.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Per block size: TN rows staged per step; each thread owns RI x RJ outputs.
template <int B> struct Cfg;
template <> struct Cfg<8>   { static constexpr int TN = 128, RI = 1, RJ = 1; };
template <> struct Cfg<16>  { static constexpr int TN = 128, RI = 2, RJ = 2; };
template <> struct Cfg<32>  { static constexpr int TN = 64,  RI = 2, RJ = 2; };
template <> struct Cfg<64>  { static constexpr int TN = 32,  RI = 4, RJ = 4; };
template <> struct Cfg<128> { static constexpr int TN = 16,  RI = 8, RJ = 8; };

template <int B> struct Threads {
  static constexpr int value = (B / Cfg<B>::RI) * (B / Cfg<B>::RJ);
};

template <typename T, int B>
__global__ void __launch_bounds__(Threads<B>::value)
bsmm_updat_nc_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const int* __restrict__ ent_c, const int* __restrict__ ent_k,
                     float* __restrict__ dw, int N, int C, int K) {
  constexpr int TN = Cfg<B>::TN, RI = Cfg<B>::RI, RJ = Cfg<B>::RJ;
  constexpr int THREADS = Threads<B>::value;
  constexpr int TJ = B / RJ;
  constexpr int P = B + 1;  // padded row
  constexpr int LOADS = TN * B / THREADS;  // elements of each operand a thread stages
  constexpr int BATCH = LOADS < 8 ? LOADS : 8;  // of them, loads in flight at once
  static_assert(TN * B % (THREADS * BATCH) == 0, "the tile must split evenly");
  __shared__ float xs[TN][P];
  __shared__ float ys[TN][P];

  const int tid = threadIdx.x;
  const int ti = tid / TJ, tj = tid % TJ;
  const int e = blockIdx.x;
  const T* xb = x + (size_t)ent_c[e] * B;
  const T* yb = dy + (size_t)ent_k[e] * B;

  float acc[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) acc[r][c] = 0.f;

  for (int n0 = 0; n0 < N; n0 += TN) {
    // A thread's global loads are issued BATCH at a time before their shared
    // stores, so they overlap instead of waiting one by one.
#pragma unroll 1
    for (int q0 = 0; q0 < LOADS; q0 += BATCH) {
      float xv[BATCH], yv[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int l = tid + (q0 + q) * THREADS;
        const int n = n0 + l / B, i = l % B;
        const bool in = n < N;
        xv[q] = in ? to_f32(xb[(size_t)n * C + i]) : 0.f;
        yv[q] = in ? to_f32(yb[(size_t)n * K + i]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int l = tid + (q0 + q) * THREADS;
        xs[l / B][l % B] = xv[q];
        ys[l / B][l % B] = yv[q];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < TN; ++m) {
      float a[RI], b[RJ];
#pragma unroll
      for (int r = 0; r < RI; ++r) a[r] = xs[m][ti * RI + r];
#pragma unroll
      for (int c = 0; c < RJ; ++c) b[c] = ys[m][tj + c * TJ];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* ob = dw + (size_t)e * B * B;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) ob[(ti * RI + r) * B + tj + c * TJ] = acc[r][c];
}

template <typename T, int B>
cudaError_t launch(const void* x, const void* dy, const int* ent_c, const int* ent_k,
                   float* dw, int N, int C, int K, int blocks, cudaStream_t stream) {
  bsmm_updat_nc_kernel<T, B><<<blocks, Threads<B>::value, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ent_c, ent_k, dw, N, C, K);
  return cudaGetLastError();
}

#define UPDAT_ARGS x, dy, ent_c, ent_k, dw, N, C, K, blocks, s

template <typename T>
cudaError_t dispatch(int bsize, const void* x, const void* dy, const int* ent_c,
                     const int* ent_k, float* dw, int N, int C, int K, int blocks,
                     cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(UPDAT_ARGS);
    case 16: return launch<T, 16>(UPDAT_ARGS);
    case 32: return launch<T, 32>(UPDAT_ARGS);
    case 64: return launch<T, 64>(UPDAT_ARGS);
    case 128: return launch<T, 128>(UPDAT_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and dy alike).
// x (N, C), dy (N, K); dw (blocks, B, B) f32.  Returns a cudaError_t
// (0 = launched).
extern "C" int bsmm_updat_nc(int dtype, int bsize, const void* x, const void* dy,
                             const int* ent_c, const int* ent_k, void* dw, int N, int C,
                             int K, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
#define UPDAT_CALL(T) dispatch<T>(bsize, x, dy, ent_c, ent_k, dwf, N, C, K, blocks, s)
  if (dtype == 0) return UPDAT_CALL(float);
  if (dtype == 1) return UPDAT_CALL(__nv_bfloat16);
  if (dtype == 2) return UPDAT_CALL(__half);
  return cudaErrorInvalidValue;
#undef UPDAT_CALL
}
