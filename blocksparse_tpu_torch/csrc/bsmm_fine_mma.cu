// Block-sparse matmul xprop for small blocks (b 8, 16, 32) on Hopper's tensor
// cores, bf16 and f16, NC orientation (feature_axis=1), in 128-deep chunks:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (TRANS).
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_fine
// (blocksparse_tpu/kernels/bsmm.py, body _xprop_fine_kernel), which gathers
// Gf = 128/b LUT entries of one output block-row into one 128-deep MXU
// contraction.  f32 inputs stay on bsmm_fine.cu, exact on the CUDA cores.
// The plan and the C interface are bsmm_fine.cu's (kernels/bsmm.py
// fine_plan): chunk_ptr[o]..chunk_ptr[o+1] are output column o's chunks;
// slot_in/slot_w (chunks, GF) each slot's input block-column and weight
// block, -1 past the column's last entry.
//
// Design: one thread block owns one (N-tile of TM = 64 rows, output column
// o); output columns run fastest in the grid, so the blocks that gather one
// x tile are resident together.  A ring stage is one chunk: the A tile (TM
// rows x 128, each row's GF slices of B elements gathered from the chunk's
// input block-columns: one 16-byte cp.async a row at b8, two at b16, four
// at b32) and the B tile (the chunk's GF W blocks stacked, 128 x B in
// fprop, read by ldmatrix.trans; B x 128 in bprop, W as stored, read by
// plain ldmatrix).  Empty slots and rows past N are zero-filled by the copy
// (src-size 0), so the mma loop has no branch.  STAGES chunks are in flight
// (the next three load while the warps run the 8 k16 steps of this one), one
// barrier a stage.  Four warps, each 16 rows by all B columns, mma.sync
// m16n8k16 into f32 registers; a warp whose rows all lie past N skips its
// mma.  The epilogue stages the tile in shared memory and writes y with
// 16-byte stores, rounded once.  An empty column writes zeros.  No atomics:
// each output's sum runs chunk by chunk, k16 step by k16 step, in a fixed
// order, so two runs give identical bits.
//
// Bound on the H100: at the canonical small-block bench row (hidden 7680,
// b8, 105,178 blocks, N = 64) a call is 0.86 GFLOP (0.0009 ms of bf16
// tensor-core work) against 15 MB of inputs and outputs (0.0046 ms): bound
// by bytes.  x (1 MB) sits in L2 and is gathered N * B * 2 bytes once per
// entry: 108 MB at b8, 54 MB at b16, 28 MB at b32, beside W's 13.5-13.8 MB,
// which is what this design spends beyond the bound.
#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS, STAGES = 4;
constexpr int TM = 64;          // rows of N a thread block owns: 16 a warp
constexpr int DEPTH = 128;      // contraction rows a chunk: GF = DEPTH / B slots
constexpr int XLD = DEPTH + 8;  // padded x row: ldmatrix rows in distinct banks

// One ring slot, in elements: the x tile (TM rows of DEPTH), then the
// weights: fprop DEPTH rows (k) of B (b8's 16-byte rows are conflict-free
// unpadded), bprop B rows (n) of DEPTH.
template <int B, bool TRANS> struct FineSlot {
  static constexpr int WLD = TRANS ? DEPTH + 8 : (B == 8 ? B : B + 8);
  static constexpr int WROWS = TRANS ? B : DEPTH;
  static constexpr int X_ELEMS = TM * XLD;
  static constexpr int ELEMS = X_ELEMS + WROWS * WLD;
};

template <typename T, int B, bool TRANS>
constexpr size_t smem_bytes() {
  constexpr size_t ring = STAGES * FineSlot<B, TRANS>::ELEMS * sizeof(T);
  constexpr size_t out = TM * (B + 8) * sizeof(T);
  return ring > out ? ring : out;
}

template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(THREADS)
bsmm_fine_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ chunk_ptr, const int* __restrict__ slot_in,
                     const int* __restrict__ slot_w, T* __restrict__ y, int N, int C, int K) {
  using S = FineSlot<B, TRANS>;
  constexpr int GF = DEPTH / B, WLD = S::WLD;
  constexpr int NT = B / 8;          // a warp's n8 tiles
  constexpr int BCH = B / 8;         // 16-byte chunks of a block row
  constexpr int RCH = DEPTH / 8;     // 16-byte chunks of a chunk row
  constexpr int WCH = DEPTH * B / 8; // 16-byte chunks of the weights
  static_assert(THREADS % RCH == 0 && (TM * RCH) % THREADS == 0, "x staging");
  static_assert(WCH % THREADS == 0, "W staging");
  static_assert(NT == 1 || NT % 2 == 0, "n8 tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = K / B;
  const int o = blockIdx.x % n_out;
  const int n0 = blockIdx.x / n_out * TM;
  const int c0 = chunk_ptr[o], chunks = chunk_ptr[o + 1] - c0;
  const bool live = n0 + warp * 16 < N;

  // Chunk s's x slices and weights into ring slot `slot`.
  auto load = [&](int s, int slot) {
    T* xs = ring + slot * S::ELEMS;
    T* ws = xs + S::X_ELEMS;
    const int* cin = slot_in + (size_t)(c0 + s) * GF;
    const int* cw = slot_w + (size_t)(c0 + s) * GF;
    {
      // every x chunk of this thread lies in one column of 16 bytes: one
      // slot, one plan read
      const int kc = tid % RCH;
      const int in = __ldg(cin + kc / BCH);
      const T* src = x + (in >= 0 ? (size_t)in * B : 0) + (kc % BCH) * 8;
#pragma unroll
      for (int i = 0; i < TM * RCH / THREADS; ++i) {
        const int m = tid / RCH + i * (THREADS / RCH);
        const bool v = in >= 0 && n0 + m < N;
        cp_async16(smem_addr(xs + m * XLD + kc * 8), v ? src + (size_t)(n0 + m) * C : x, v);
      }
    }
#pragma unroll
    for (int i = 0; i < WCH / THREADS; ++i) {
      const int c = tid + i * THREADS;
      int t, src_off, dst_off;
      if constexpr (TRANS) {  // ws[j][t*B + i] = W[w_t][j][i]
        const int j = c / RCH, kc = c % RCH;
        t = kc / BCH;
        src_off = j * B + (kc % BCH) * 8;
        dst_off = j * WLD + kc * 8;
      } else {                // ws[t*B + i][j] = W[w_t][i][j]
        const int r = c / BCH;
        t = r / B;
        src_off = (r % B) * B + (c % BCH) * 8;
        dst_off = r * WLD + (c % BCH) * 8;
      }
      const int wi = __ldg(cw + t);
      cp_async16(smem_addr(ws + dst_off), wi >= 0 ? w + (size_t)wi * B * B + src_off : w,
                 wi >= 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  // The mma of one ring slot: DEPTH / 16 k16 steps over the warp's tiles.
  auto compute = [&](int slot) {
    const T* xs = ring + slot * S::ELEMS;
    const T* ws = xs + S::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < DEPTH; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(xs + (warp * 16 + (lane & 15)) * XLD + kk + (lane >> 4) * 8));
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        // lanes 0-7 address k rows 0-7 (or n rows with k 0-7), lanes 8-15 k 8-15
        if constexpr (TRANS)
          ldsm_x2(b[0], smem_addr(ws + (lane & 7) * WLD + kk + ((lane >> 3) & 1) * 8));
        else
          ldsm_x2_t(b[0], smem_addr(ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * WLD));
      } else {
#pragma unroll
        for (int np = 0; np < NT; np += 2) {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          uint32_t r[4];
          const int n = np * 8 + (lane >> 4) * 8;
          const int k = kk + ((lane >> 3) & 1) * 8;
          if constexpr (TRANS)
            ldsm_x4(r, smem_addr(ws + (n + (lane & 7)) * WLD + k));
          else
            ldsm_x4_t(r, smem_addr(ws + (k + (lane & 7)) * WLD + n));
          b[np][0] = r[0];
          b[np][1] = r[1];
          b[np + 1][0] = r[2];
          b[np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[nt], a, b[nt], T());
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < chunks; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk s landed; every warp is done with slot (s - 1)
    if (s + STAGES - 1 < chunks) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    if (live) compute(s % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the tile through shared memory, then 16-byte rows of y
  constexpr int OLD = B + 8;
  T* os = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = warp * 16 + g, c = nt * 8 + tg * 2;
    store2(os + r * OLD + c, acc[nt][0], acc[nt][1]);
    store2(os + (r + 8) * OLD + c, acc[nt][2], acc[nt][3]);
  }
  __syncthreads();
  constexpr int OCH = B / 8;
  for (int c = tid; c < TM * OCH; c += THREADS) {
    const int r = c / OCH, q = c % OCH;
    if (n0 + r < N)
      *reinterpret_cast<uint4*>(y + (size_t)(n0 + r) * K + (size_t)o * B + q * 8) =
          *reinterpret_cast<const uint4*>(os + r * OLD + q * 8);
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch_one(const void* x, const void* w, const int* chunk_ptr, const int* slot_in,
                       const int* slot_w, void* y, int N, int C, int K, cudaStream_t stream) {
  auto kernel = bsmm_fine_mma_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<T, B, TRANS>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((N + TM - 1) / TM) * (K / B);
  kernel<<<blocks, THREADS, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           chunk_ptr, slot_in, slot_w, static_cast<T*>(y), N, C,
                                           K);
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

// bsmm_fine.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any other
// dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0
// for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  bsize 8, 16 or 32.
// x and w must be 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_fine_mma_nc(int dtype, int bsize, int trans_w, const void* x,
                                const void* w, const int* chunk_ptr, const int* slot_in,
                                const int* slot_w, void* y, int N, int C, int K,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans_w, FINE_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans_w, FINE_ARGS);
  return cudaErrorInvalidValue;
}
