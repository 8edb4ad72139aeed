// Merge of the split route's partial tiles, NC orientation:
//   y[n, o * B + j] = round( sum_p tiles[n, idx[o, p] * B + j] ),  p = 0..P-1
// summed in f32 in phase order, rounded once to the output dtype.
//
// Replaces the TPU kernel merge_phased_tiles (blocksparse_tpu/kernels/
// bsmm.py, body _merge_tiles_kernel), which gather-sums the partial (b, TN)
// tiles that several phased-cover groups wrote for one canonical row.
//
// tiles: (N, T * B) f32 from bsmm_xprop_nc_partials (bsmm_fprop.cu), one
// tile a run of consecutive LUT entries of one output block-column.  idx:
// (n_out, P) int32 tile ids in phase order; a column with fewer than P
// tiles, or none, points the rest at a tile whose run is empty, which the
// partial kernel wrote as zeros (+0 leaves an f32 sum unchanged).
//
// Design: a pure gather-sum.  Each thread owns 4 consecutive outputs of one
// row: P 16-byte loads (float4; B is a multiple of 8, so every tile row is
// 16-byte aligned), 4 f32 sums in phase order, one store of 4 values.  No
// atomics, each output written once.
//
// Bound on the H100: bytes, (P reads of f32 + one write) a value; at the
// canonical hidden-2560 row (N 64, 80 columns of b32, 2 phases) 1 MB,
// about 0.3 us at 3.35 TB/s: at that size the launch is the cost.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<__nv_bfloat162*>(p)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(p)[1] = hi;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 lo = __floats2half2_rn(v.x, v.y);
  __half2 hi = __floats2half2_rn(v.z, v.w);
  reinterpret_cast<__half2*>(p)[0] = lo;
  reinterpret_cast<__half2*>(p)[1] = hi;
}

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
bsmm_merge_kernel(const float* __restrict__ tiles, const int* __restrict__ idx,
                  T* __restrict__ y, int N, int n_out, int P, int B, int T_all) {
  const int K4 = n_out * B / 4;  // groups of 4 outputs in a row
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= (long long)N * K4) return;
  const int n = (int)(q / K4), c4 = (int)(q % K4);
  const int o = c4 / (B / 4), j = (c4 % (B / 4)) * 4;
  const int* io = idx + (size_t)o * P;
  const float* row = tiles + (size_t)n * T_all * B + j;
  float4 acc = *reinterpret_cast<const float4*>(row + (size_t)__ldg(io) * B);
  for (int p = 1; p < P; ++p) {
    const float4 t = *reinterpret_cast<const float4*>(row + (size_t)__ldg(io + p) * B);
    acc.x += t.x; acc.y += t.y; acc.z += t.z; acc.w += t.w;
  }
  store4(y + (size_t)n * n_out * B + (size_t)o * B + j, acc);
}

template <typename T>
cudaError_t launch(const float* tiles, const int* idx, void* y, int N, int n_out, int P,
                   int B, int T_all, cudaStream_t s) {
  const long long work = (long long)N * n_out * B / 4;
  const long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bsmm_merge_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      tiles, idx, static_cast<T*>(y), N, n_out, P, B, T_all);
  return cudaGetLastError();
}

}  // namespace

// dtype of y: 0 = float32, 1 = bfloat16, 2 = float16.  tiles (N, T_all *
// bsize) f32, idx (n_out, P) int32, y (N, n_out * bsize); bsize a multiple
// of 8, N >= 1.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_merge_nc(int dtype, int bsize, const float* tiles, const int* idx,
                             void* y, int N, int n_out, int P, int T_all, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bsize % 8 != 0 || P < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(tiles, idx, y, N, n_out, P, bsize, T_all, s);
  if (dtype == 1) return launch<__nv_bfloat16>(tiles, idx, y, N, n_out, P, bsize, T_all, s);
  if (dtype == 2) return launch<__half>(tiles, idx, y, N, n_out, P, bsize, T_all, s);
  return cudaErrorInvalidValue;
}
