// The unfused block-sparse attention's sparse x dense products in f32 on the
// CUDA cores (nn_op, tn_op and the gradients of the three ops):
//   NN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]   . x_blk(ent_x[e]),
//   TN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]^T . x_blk(ent_x[e]).
// The C interface is bst_xn_mma.cu's; this file takes f32 (dtype 0) only.
//
// Replaces, for f32 inputs, the TPU kernel xprop_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) in its _xn_impl_pallas use, exact on
// the CUDA cores (no TF32: the reference's f32 dots are exact).
//
// Design: one thread block per (output block-row, 64-column chunk of the
// head, batch*head), 256 threads, each keeping B/4 outputs of the (B x 64)
// tile in registers.  For each entry of the row, in order, the block stages
// the weight block (B x B, padded to B + 1 columns) and the x block's chunk
// (B x 64, zero past hs), and every output adds its B products in
// ascending order (fmaf): no atomics, two runs give equal bits.  A row with
// no entries writes zeros.
//
// Bound on the H100: at the LM's check shape in f32 (batch 8, ctx 2048, B
// 64, 312 blocks, 2 heads of 256) a call reads 81.8 MB of weights and x
// (33.6 MB) and writes y (33.6 MB): 44 us at 3.35 TB/s, against 10.5 GFLOP,
// 157 us at 67 TFLOP/s of f32: bound by operations.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256, HC = 64;  // head columns a thread block

template <int B, bool TRANS>
__global__ void __launch_bounds__(THREADS)
bst_xn_kernel(const float* __restrict__ w, const float* __restrict__ x, float* __restrict__ y,
              long long sx_b, long long sx_r, const int* __restrict__ row_ptr,
              const int* __restrict__ ent_w, const int* __restrict__ ent_x, int hs, int heads,
              int lut_heads, int rows, int blocks) {
  constexpr int PER = B * HC / THREADS;  // outputs a thread: B / 4
  __shared__ float ws[B][B + 1], xs[B][HC];
  const int tid = threadIdx.x;
  const int r = blockIdx.x, c0 = blockIdx.y * HC, nh = blockIdx.z;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int e0 = row_ptr[lh * (rows + 1) + r];
  const int cnt = row_ptr[lh * (rows + 1) + r + 1] - e0;
  const int* ew = ent_w + static_cast<size_t>(lh) * blocks + e0;
  const int* ex = ent_x + static_cast<size_t>(lh) * blocks + e0;
  const float* wbase = w + static_cast<size_t>(nh) * blocks * B * B;
  const float* xbase = x + n * sx_b + static_cast<size_t>(h) * hs + c0;

  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = 0.f;
  for (int e = 0; e < cnt; ++e) {
    const float* wb = wbase + static_cast<size_t>(ew[e]) * B * B;
    const float* xb = xbase + static_cast<size_t>(ex[e]) * B * sx_r;
    __syncthreads();  // the previous entry is read
    for (int i = tid; i < B * B; i += THREADS) ws[i / B][i % B] = wb[i];
    for (int i = tid; i < B * HC; i += THREADS) {
      const int l = i / HC, c = i % HC;
      xs[l][c] = c0 + c < hs ? xb[static_cast<size_t>(l) * sx_r + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * THREADS, i = idx / HC, c = idx % HC;
#pragma unroll 8
      for (int l = 0; l < B; ++l) acc[p] = fmaf(TRANS ? ws[l][i] : ws[i][l], xs[l][c], acc[p]);
    }
  }
  const size_t ld_y = static_cast<size_t>(heads) * hs;
  float* ybase = y + (static_cast<size_t>(n) * rows + r) * B * ld_y + static_cast<size_t>(h) * hs + c0;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = tid + p * THREADS, i = idx / HC, c = idx % HC;
    if (c0 + c < hs) ybase[i * ld_y + c] = acc[p];
  }
}

template <int B, bool TRANS>
cudaError_t launch_one(const float* w, const float* x, float* y, const long long* st,
                       const int* row_ptr, const int* ent_w, const int* ent_x, int hs,
                       int batch, int heads, int lut_heads, int rows, int blocks,
                       cudaStream_t stream) {
  const dim3 grid(rows, (hs + HC - 1) / HC, batch * heads);
  bst_xn_kernel<B, TRANS><<<grid, THREADS, 0, stream>>>(w, x, y, st[0], st[1], row_ptr, ent_w,
                                                        ent_x, hs, heads, lut_heads, rows,
                                                        blocks);
  return cudaGetLastError();
}

#define XN_ARGS fw, fx, fy, strides, row_ptr, ent_w, ent_x, hs, batch, heads, lut_heads, rows, blocks, s

template <int B>
cudaError_t launch(int trans, const float* fw, const float* fx, float* fy,
                   const long long* strides, const int* row_ptr, const int* ent_w,
                   const int* ent_x, int hs, int batch, int heads, int lut_heads, int rows,
                   int blocks, cudaStream_t s) {
  return trans ? launch_one<B, true>(XN_ARGS) : launch_one<B, false>(XN_ARGS);
}

}  // namespace

// bst_xn_mma.cu's interface for f32 (dtype 0); any other dtype, block size
// or a head size that is not a positive multiple of 8 returns
// cudaErrorInvalidValue.  strides: x's batch and row strides in elements.
// Returns a cudaError_t (0 = launched).
extern "C" int bst_xn(int dtype, int bsize, int hs, int trans, const void* w, const void* x,
                      void* y, const long long* strides, const int* row_ptr, const int* ent_w,
                      const int* ent_x, int batch, int heads, int lut_heads, int rows,
                      int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 || hs <= 0 || hs % 8) return cudaErrorInvalidValue;
  const float* fw = static_cast<const float*>(w);
  const float* fx = static_cast<const float*>(x);
  float* fy = static_cast<float*>(y);
  switch (bsize) {
    case 8: return launch<8>(trans, XN_ARGS);
    case 16: return launch<16>(trans, XN_ARGS);
    case 32: return launch<32>(trans, XN_ARGS);
    case 64: return launch<64>(trans, XN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}
