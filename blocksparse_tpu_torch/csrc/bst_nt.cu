// The unfused block-sparse attention's scores in f32 on the CUDA cores (the
// NT product of BlocksparseTransformer.nt_op):
//   w[n, h, e] = a_blk(q_e) . b_blk(k_e)^T over the head size hs,
// for every layout block e of the instance's layout head.  The C interface
// is bst_nt_mma.cu's; this file takes f32 (dtype 0) only.
//
// Replaces, for f32 inputs, the TPU kernel updat_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) in its _nt_impl_pallas use.  The
// reference's f32 dots run at full precision, so this kernel stays exact on
// the CUDA cores (no TF32).
//
// Design: one thread block per (query block-row, batch*head), 256 threads.
// For each entry of the row the block stages the query block and the key
// block in 32-column slabs of hs (zero past hs) and each thread keeps its
// (B*B)/256 scores in registers, each one sum over hs in ascending order
// (fmaf): two runs give equal bits.  The key slab is padded to 33 columns
// so the threads of a warp, on neighbouring key rows, hit distinct banks.
// The query block is staged again for every entry (from L2), which is what
// this simple design spends; f32 is the exact route, not the fast one.
//
// Bound on the H100: at the LM's check shape in f32 (batch 8, ctx 2048, B
// 64, 312 blocks, 2 heads of 256) a call writes 81.8 MB of scores and reads
// q and k (2 x 33.6 MB), 44 us at 3.35 TB/s, against 10.5 GFLOP, 157 us at
// 67 TFLOP/s of f32: bound by operations.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256, KC = 32;  // hs columns a slab

template <int B>
__global__ void __launch_bounds__(THREADS)
bst_nt_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ w,
              long long sa_b, long long sa_r, long long sb_b, long long sb_r,
              const int* __restrict__ row_ptr, const int* __restrict__ ent_k, int hs, int heads,
              int lut_heads, int rows, int blocks) {
  constexpr int PER = (B * B + THREADS - 1) / THREADS;  // scores a thread
  __shared__ float qs[B][KC + 1], ks[B][KC + 1];
  const int tid = threadIdx.x;
  const int r = blockIdx.x, nh = blockIdx.y;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int e0 = row_ptr[lh * (rows + 1) + r];
  const int cnt = row_ptr[lh * (rows + 1) + r + 1] - e0;
  const int* ek = ent_k + static_cast<size_t>(lh) * blocks + e0;
  const float* abase = a + n * sa_b + static_cast<size_t>(r) * B * sa_r + static_cast<size_t>(h) * hs;
  const float* bbase = b + n * sb_b + static_cast<size_t>(h) * hs;

  for (int e = 0; e < cnt; ++e) {
    const float* kb = bbase + static_cast<size_t>(ek[e]) * B * sb_r;
    float acc[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) acc[p] = 0.f;
    for (int c0 = 0; c0 < hs; c0 += KC) {
      __syncthreads();  // the previous slab is read
      for (int i = tid; i < B * KC; i += THREADS) {
        const int m = i / KC, c = i % KC;
        const bool v = c0 + c < hs;
        qs[m][c] = v ? abase[static_cast<size_t>(m) * sa_r + c0 + c] : 0.f;
        ks[m][c] = v ? kb[static_cast<size_t>(m) * sb_r + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = tid + p * THREADS;
        if (idx < B * B) {
          const int i = idx / B, j = idx % B;
#pragma unroll 8
          for (int c = 0; c < KC; ++c) acc[p] = fmaf(qs[i][c], ks[j][c], acc[p]);
        }
      }
    }
    float* dst = w + (static_cast<size_t>(nh) * blocks + e0 + e) * B * B;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * THREADS;
      if (idx < B * B) dst[idx] = acc[p];
    }
  }
}

template <int B>
cudaError_t launch(const float* a, const float* b, float* w, const long long* st,
                   const int* row_ptr, const int* ent_k, int hs, int batch, int heads,
                   int lut_heads, int rows, int blocks, cudaStream_t stream) {
  const dim3 grid(rows, batch * heads);
  bst_nt_kernel<B><<<grid, THREADS, 0, stream>>>(a, b, w, st[0], st[1], st[2], st[3], row_ptr,
                                                 ent_k, hs, heads, lut_heads, rows, blocks);
  return cudaGetLastError();
}

}  // namespace

// bst_nt_mma.cu's interface for f32 (dtype 0); any other dtype, block size
// or a head size that is not a positive multiple of 8 returns
// cudaErrorInvalidValue.  strides: a's batch and row strides, then b's, in
// elements.  Returns a cudaError_t (0 = launched).
extern "C" int bst_nt(int dtype, int bsize, int hs, const void* a, const void* b, void* w,
                      const long long* strides, const int* row_ptr, const int* ent_k, int batch,
                      int heads, int lut_heads, int rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || hs <= 0 || hs % 8) return cudaErrorInvalidValue;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fw = static_cast<float*>(w);
#define NT_ARGS fa, fb, fw, strides, row_ptr, ent_k, hs, batch, heads, lut_heads, rows, blocks, s
  switch (bsize) {
    case 8: return launch<8>(NT_ARGS);
    case 16: return launch<16>(NT_ARGS);
    case 32: return launch<32>(NT_ARGS);
    case 64: return launch<64>(NT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef NT_ARGS
}
