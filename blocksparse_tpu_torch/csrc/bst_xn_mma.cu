// The unfused block-sparse attention's sparse x dense products on Hopper's
// tensor cores, bf16 and f16 (nn_op and tn_op of BlocksparseTransformer,
// and the gradients of all three ops):
//   NN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]   . x_blk(ent_x[e]),
//   TN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]^T . x_blk(ent_x[e]),
// each output block-row r a (B x hs) tile of y (batch, rows*B, heads*hs),
// summed in f32 in entry order and rounded once; a row with no entries is
// zeros.  NN walks the query-row CSR (weights in row order, x = v at the
// key blocks), TN the key-row CSR (x = q or dy at the query blocks).  x is
// read in place through its batch and row strides.
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) in its _xn_impl_pallas use
// (blocksparse_tpu/ops/transformer.py), vmapped there over batch*heads with
// the per-instance weight panels of dense_tile_panels (transposed cells for
// TN).  f32 inputs run bst_xn.cu, exact on the CUDA cores.
//
// Design: one thread block per (output block-row r, 64-column chunk of the
// head, batch*head): a 64-column chunk keeps a 64 x 64 f32 tile at 32
// accumulators a thread at hs 256, where a whole head would not fit in
// registers.  The row's entries go in stages of KD = 64 contraction rows:
// E = 64 / B entries, their weight blocks side by side as one (B x 64) A
// tile (as stored for NN, [i][l]; for TN kept as stored, [l][i], and read
// transposed by ldmatrix.trans) and their x blocks stacked as one (64 x
// 64) B tile read by ldmatrix.trans, so a stage is one 64-deep product at
// every block size (b8: eight entries a stage, rows padded to one m16).
// Copies are 16-byte cp.async, zero-filled past the row's last entry and
// past hs, in a three-slot ring.  Four warps split the (max(B, 16) x 64)
// tile as bst_nt_mma.cu does.  No atomics: each output is one chain of k16
// steps in entry order, so two runs give equal bits.
//
// Bound on the H100: at the LM's check shape (batch 8, ctx 2048, B 64, 312
// blocks, 2 heads of 256) a call reads the 40.9 MB of scores and x (16.8
// MB) and writes y (16.8 MB): 74.4 MB, 22 us at 3.35 TB/s, against 10.5
// GFLOP, 11 us of bf16 tensor-core work: bound by bytes.  Each weight
// block is read once per 64-column chunk of the head (4 times at hs 256,
// from L2 after the first), which is what the chunking spends.
#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS, STAGES = 3;
constexpr int KD = 64;  // contraction rows a stage: E = KD / B entries
constexpr int HC = 64;  // head columns a thread block
constexpr int BLD = HC + 8;

template <int B, bool TRANS> struct XnShape {
  static constexpr int E = KD / B;
  static constexpr int MP = B < 16 ? 16 : B;  // output rows (b8: one m16)
  static constexpr int WM = MP / 16, WN = WARPS / WM;
  static constexpr int NT = HC / 8 / WN;      // a warp's n8 tiles
  // A tile: NN [m][k] (MP rows of KD + 8); TN [k][m] (KD rows of MP + 8)
  static constexpr int ALD = TRANS ? MP + 8 : KD + 8;
  static constexpr int A_ELEMS = TRANS ? KD * ALD : MP * ALD;
  static constexpr int ELEMS = A_ELEMS + KD * BLD;
};

template <typename T, int B, bool TRANS>
constexpr size_t smem_bytes() {
  return STAGES * XnShape<B, TRANS>::ELEMS * sizeof(T);
}

template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(THREADS)
bst_xn_mma_kernel(const T* __restrict__ w, const T* __restrict__ x, T* __restrict__ y,
                  long long sx_b, long long sx_r, const int* __restrict__ row_ptr,
                  const int* __restrict__ ent_w, const int* __restrict__ ent_x, int hs,
                  int heads, int lut_heads, int rows, int blocks) {
  using S = XnShape<B, TRANS>;
  static_assert(S::NT % 2 == 0, "n8 tiles are loaded in pairs");
  constexpr int BCH = B / 8;  // 16-byte chunks of a weight-block row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int r = blockIdx.x, c0 = blockIdx.y * HC, nh = blockIdx.z;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int e0 = row_ptr[lh * (rows + 1) + r];
  const int cnt = row_ptr[lh * (rows + 1) + r + 1] - e0;
  const int* ew = ent_w + static_cast<size_t>(lh) * blocks + e0;
  const int* ex = ent_x + static_cast<size_t>(lh) * blocks + e0;
  const T* wbase = w + static_cast<size_t>(nh) * blocks * B * B;
  const T* xbase = x + n * sx_b + static_cast<size_t>(h) * hs + c0;
  const int stages = (cnt + S::E - 1) / S::E;

  // the pad rows (NN) or columns (TN) of a b8 A tile are never loaded: zero
  // them once in every slot
  if constexpr (B < 16) {
    unsigned short* bits = reinterpret_cast<unsigned short*>(ring);
    for (int i = tid; i < STAGES * S::A_ELEMS; i += THREADS)
      bits[i / S::A_ELEMS * S::ELEMS + i % S::A_ELEMS] = 0;
    __syncthreads();
  }

  auto load = [&](int s, int slot) {
    T* as = ring + slot * S::ELEMS;
    T* bs = as + S::A_ELEMS;
    // the weight blocks, B x B each as stored ([l][i] rows of B)
    for (int c = tid; c < S::E * B * BCH; c += THREADS) {
      const int j = c / (B * BCH), row = c / BCH % B, cc = c % BCH;
      const int e = s * S::E + j;
      const bool v = e < cnt;
      const T* src = v ? wbase + static_cast<size_t>(__ldg(ew + e)) * B * B + row * B + cc * 8 : w;
      // NN: as[row][j*B + cc*8 ..]; TN: as[j*B + row][cc*8 ..]
      T* dst = TRANS ? as + (j * B + row) * S::ALD + cc * 8 : as + row * S::ALD + j * B + cc * 8;
      cp_async16(smem_addr(dst), src, v);
    }
    // the x blocks stacked: KD rows of HC columns
    for (int c = tid; c < KD * (HC / 8); c += THREADS) {
      const int row = c / (HC / 8), cc = c % (HC / 8);
      const int e = s * S::E + row / B;
      const bool v = e < cnt && c0 + cc * 8 < hs;
      const T* src = x;
      if (v) src = xbase + (static_cast<size_t>(__ldg(ex + e)) * B + row % B) * sx_r + cc * 8;
      cp_async16(smem_addr(bs + row * BLD + cc * 8), src, v);
    }
  };

  float acc[S::NT][4];
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const int nbase = wn * S::NT * 8;
  auto compute = [&](int slot) {
    const T* as = ring + slot * S::ELEMS;
    const T* bs = as + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 16) {
      uint32_t af[4];
      if constexpr (TRANS) {
        // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        // of A = as^T: smem rows are k, read transposed
        ldsm_x4_t(af, smem_addr(as + (kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * S::ALD +
                                wm * 16 + ((lane >> 3) & 1) * 8));
      } else {
        ldsm_x4(af, smem_addr(as + (wm * 16 + (lane & 15)) * S::ALD + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < S::NT; np += 2) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t rr[4];
        ldsm_x4_t(rr, smem_addr(bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * BLD + nbase +
                                np * 8 + (lane >> 4) * 8));
        const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
        mma(acc[np], af, b0, T());
        mma(acc[np + 1], af, b1, T());
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with slot (s - 1)
    if (s + STAGES - 1 < stages) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    compute(s % STAGES);
  }
  cp_async_wait<0>();

  // y's rows r*B + i of this head's columns c0 + col, rounded once
  const int g = lane >> 2, tg = lane & 3;
  T* ybase = y + (static_cast<size_t>(n) * rows * B + static_cast<size_t>(r) * B) *
                     (static_cast<size_t>(heads) * hs) +
             static_cast<size_t>(h) * hs + c0;
  const size_t ld_y = static_cast<size_t>(heads) * hs;
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt) {
    const int col = nbase + nt * 8 + tg * 2;
    if (c0 + col >= hs) continue;
    const int i0 = wm * 16 + g;
    if (i0 < B) store2(ybase + i0 * ld_y + col, acc[nt][0], acc[nt][1]);
    if (i0 + 8 < B) store2(ybase + (i0 + 8) * ld_y + col, acc[nt][2], acc[nt][3]);
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch_one(const void* w, const void* x, void* y, const long long* st,
                       const int* row_ptr, const int* ent_w, const int* ent_x, int hs,
                       int batch, int heads, int lut_heads, int rows, int blocks,
                       cudaStream_t stream) {
  auto kernel = bst_xn_mma_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<T, B, TRANS>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, (hs + HC - 1) / HC, batch * heads);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(w), static_cast<const T*>(x),
                                           static_cast<T*>(y), st[0], st[1], row_ptr, ent_w,
                                           ent_x, hs, heads, lut_heads, rows, blocks);
  return cudaGetLastError();
}

#define XN_ARGS w, x, y, strides, row_ptr, ent_w, ent_x, hs, batch, heads, lut_heads, rows, blocks, s

template <typename T, int B>
cudaError_t launch(int trans, const void* w, const void* x, void* y, const long long* strides,
                   const int* row_ptr, const int* ent_w, const int* ent_x, int hs, int batch,
                   int heads, int lut_heads, int rows, int blocks, cudaStream_t s) {
  return trans ? launch_one<T, B, true>(XN_ARGS) : launch_one<T, B, false>(XN_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans, const void* w, const void* x, void* y,
                     const long long* strides, const int* row_ptr, const int* ent_w,
                     const int* ent_x, int hs, int batch, int heads, int lut_heads, int rows,
                     int blocks, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(trans, XN_ARGS);
    case 16: return launch<T, 16>(trans, XN_ARGS);
    case 32: return launch<T, 32>(trans, XN_ARGS);
    case 64: return launch<T, 64>(trans, XN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (batch, rows * bsize, heads * hs) = NN (trans 0) or TN (trans 1) of the
// weights w (batch, heads, blocks, bsize, bsize) and x (batch, ctx_in,
// heads * hs) over the CSR row_ptr (lut_heads, rows + 1), ent_w, ent_x
// (lut_heads, blocks), bf16 (dtype 1) or f16 (dtype 2); any other dtype,
// block size or a head size that is not a multiple of 8 returns
// cudaErrorInvalidValue.  strides: x's batch and row strides in elements;
// w, x 16-byte aligned, x's strides multiples of 8.  Returns a cudaError_t
// (0 = launched).
extern "C" int bst_xn_mma(int dtype, int bsize, int hs, int trans, const void* w, const void* x,
                          void* y, const long long* strides, const int* row_ptr,
                          const int* ent_w, const int* ent_x, int batch, int heads,
                          int lut_heads, int rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs <= 0 || hs % 8) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans, XN_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans, XN_ARGS);
  return cudaErrorInvalidValue;
}
