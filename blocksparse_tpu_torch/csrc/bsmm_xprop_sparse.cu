// Block-sparse matmul xprop for sparse column groups on Hopper: warpgroup
// tensor-core products (wgmma) fed by TMA and bulk copies, bf16 and f16,
// in the NC orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w).
// Block size 32 (b8 and b16 stay on bsmm_xprop_mma.cu, b64 and b128 on
// bsmm_xprop_wgmma.cu: at b64 it measured 3% slower, its packing
// included).
//
// Replaces, for bf16 and f16 inputs on the unsplit route, the TPU kernels
// xprop_pallas_dense_tile, xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py:1422, :507, :674, :158) where the route
// rule (xprop_kernel in kernels/bsmm.py) picks it: b32 products whose
// tiles fill 0.3 of the card, first of all the sparse ones, whose column
// groups of bsmm_xprop_wgmma.cu stage an x tile for fewer than about
// three of their columns (bench.py's random 8192^2 b32 op at d 0.25, the
// conv's fprop), and since it measured faster at every b32 shape also the
// LM's MLP products and the conv's bprop.  The split route stays on
// bsmm_xprop_mma.cu.
//
// Bound on the H100: bench.py's random op (8192^2, b32, d 0.25, N 2048) is
// 68.7 GFLOP, 0.069 ms of bf16 tensor-core work, against ~0.1 GB of inputs
// and outputs: bound by operations.  What held bsmm_xprop_wgmma.cu back
// there was not the bytes but how they arrive and are used (the H100 runs
// in PERF.md): a TMA box a weight block, 2 KB, cost an SM about what an
// 8 KB one did, and its m64n32k16 products, one a present column, ran
// well under the tensor cores' rate.  A cluster multicasting the x box,
// which cuts the bytes read from L2, gained nothing.
//
// The design: bsmm_xprop_wgmma.cu's skeleton (a persistent, warp-
// specialised kernel: one producer warp keeps a ring of STAGES slots full,
// two consumer warpgroups with f32 accumulators for a 128-row N-tile by
// 256 output features, setmaxnreg; an absent product issues nothing),
// with three changes:
// - a stage stages the x tile of 64 input features, TM x 64 in the
//   128-byte swizzle, one TMA box: an item is a pair of neighbouring input
//   blocks (H = 2 halves); four k16 steps a stage;
// - its weights arrive in one bulk copy: the wrapper packs W in the
//   plan's order (xprop_sparse_plan in kernels/bsmm.py: item by item, its
//   present (half, column pair) slots, two blocks a pair, zeros for a
//   pair's absent block), each block in the layout TMA's 64-byte swizzle
//   would give it (the pack kernel below), so the slot's pairs lie back
//   to back and the k-th present one is at k pairs past the x tile;
// - the product is transposed, D = W^T . x^T (features x rows): warpgroup
//   wg owns rows wg * 64 .. of the tile for every pair of the group, one
//   m64n64k16 a present (half, pair) and k16 step, A the pair's two
//   blocks (M-major in fprop, K-major in bprop), B its rows of the x
//   tile; the epilogue transposes D back through shared memory.
// A slot goes back to the producer as soon as its products are done
// (wgmma_wait<0>): with three slots of 48 KB that keeps two stages of
// loads in flight, which gained more than overlapping one stage's
// products with the next's issue.  The producer reads the plan 32 items
// at a time (lane l item l), a batch ahead, and hands each stage's pair
// mask to the consumers in shared memory (published by the full
// barrier's arrive).
//
// Order: each output column sums its LUT entries in LUT order (ascending
// input blocks: the items, then the halves of a pair), k16 step by k16
// step, unrounded f32, rounded once at the epilogue; no atomics, so two
// runs give identical bits; an empty column writes zeros.  The sum is the
// one bsmm_xprop_wgmma.cu takes: the two give the same bits on finite
// inputs (the zero block of a pair's absent column adds +0).  An infinity
// or a NaN in x meets that zero block too: it turns the partner column's
// outputs in its row to NaN where bsmm_xprop_wgmma.cu, bsmm_xprop_mma.cu
// and the plain version skip the block (a non-finite input is never
// hidden, only spread to more outputs).
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int TM = 128;                   // rows of N a thread block holds
constexpr int FEATURES = 256;             // output features a group
constexpr int XA = 64;                    // input features a stage (128-byte rows)
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int RING = 144 * 1024;          // bytes of ring stages
constexpr int OLD = FEATURES + 8;         // a staged output row, elements
constexpr int OUT = TM * OLD * 2;         // bytes of the staged output tile

template <int B> struct Cfg {
  static_assert(B == 32, "block size 32");
  static constexpr int H = XA / B;            // input blocks a stage (halves)
  static constexpr int G = FEATURES / B;      // output columns a group
  static constexpr int PAIRS = G / 2;         // pairs of columns a group
  static constexpr int MB = H * PAIRS;        // (half, pair) slots a stage
  static constexpr int X_BYTES = TM * XA * 2;
  static constexpr int W_BYTES = B * B * 2;   // a weight block
  static constexpr int P_BYTES = 2 * W_BYTES; // a pair's two blocks
  static constexpr int STAGE = X_BYTES + MB * P_BYTES;
  static constexpr int STAGES = RING / STAGE;
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "ring stages");
};

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

template <int B>
constexpr size_t smem_bytes() {
  // 1 KB to align the ring, the ring, the staged output tile, a full and
  // an empty mbarrier and the consumers' slot mask a slot
  return 1024 + RING + OUT + Cfg<B>::STAGES * (2 * sizeof(uint64_t) + sizeof(int));
}

// x (N, C) through xmap (boxes of XA x TM); wp: the packed weight blocks;
// group g: items u_ptr[g] .. u_ptr[g + 1] (u_in: the item's x columns
// start at u_in * XA; u_pairs: bit h * PAIRS + m for the pair of column
// slots 2m, 2m + 1 in half h; its present pairs' blocks wp[u_woff[item]]
// .., two a pair), columns grp_col[g * G + j] (-1 past the last).  Tile t
// = (N-tile t / groups, group t % groups); the thread block walks t =
// blockIdx.x, + gridDim.x, ...
template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
bsmm_xprop_sparse_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ wp,
                         const int* __restrict__ u_ptr, const int* __restrict__ u_in,
                         const int* __restrict__ u_pairs, const int* __restrict__ u_woff,
                         const int* __restrict__ grp_col, T* __restrict__ y, int N, int K,
                         int groups) {
  using S = Cfg<B>;
  constexpr int G = S::G, PAIRS = S::PAIRS, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  T* os = reinterpret_cast<T*>(ring + RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING + OUT);
  uint64_t* empty = full + STAGES;
  volatile unsigned* slot_mask = reinterpret_cast<volatile unsigned*>(empty + STAGES);

  const int tid = threadIdx.x;
  // the groups of one N-tile run fastest: the tiles in flight read a few
  // x tiles, which come from device memory about once
  const int tiles = groups * ((N + TM - 1) / TM);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: the first warp keeps the ring full, tile after tile.
    // Lane l holds item b0 + l's plan entries (the batch at b0) and the
    // next batch's, read a batch ahead; lane 0 hands each stage's slot
    // mask to the consumers and issues its x box and its one bulk copy of
    // the item's weight blocks ----
    setmaxnreg_dec<40>();
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      int it = 0;  // ring steps so far: slot it % STAGES, round it / STAGES
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int grp = tile % groups, n0 = tile / groups * TM;
        const int t0 = __ldg(u_ptr + grp), t1 = __ldg(u_ptr + grp + 1);
        auto fetch = [&](int t, int& m, int& in, int& off) {
          if (t + lane < t1) {
            m = __ldg(u_pairs + t + lane);
            in = __ldg(u_in + t + lane);
            off = __ldg(u_woff + t + lane);
          }
        };
        int m0 = 0, in0 = 0, off0 = 0, m1 = 0, in1 = 0, off1 = 0;
        fetch(t0, m0, in0, off0);
        fetch(t0 + 32, m1, in1, off1);
        for (int b0 = t0; b0 < t1; b0 += 32) {
          for (int k = 0; k < 32 && b0 + k < t1; ++k, ++it) {
            const unsigned mask = static_cast<unsigned>(__shfl_sync(0xffffffffu, m0, k));
            const int in = __shfl_sync(0xffffffffu, in0, k);
            const int off = __shfl_sync(0xffffffffu, off0, k);
            const int slot = it % STAGES;
            mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
            if (lane == 0) {
              unsigned char* st = ring + slot * S::STAGE;
              const unsigned wbytes = __popc(mask) * S::P_BYTES;
              slot_mask[slot] = mask;
              mbar_expect_tx(full + slot, S::X_BYTES + wbytes);
              tma_load_2d(st, &xmap, full + slot, in * XA, n0);
              if (wbytes)
                bulk_load(st + S::X_BYTES, wp + static_cast<size_t>(off) * B * B, wbytes,
                          full + slot);
            }
          }
          m0 = m1, in0 = in1, off0 = off1;
          fetch(b0 + 64, m1, in1, off1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 .. of each tile, for
    // every pair of the group, as D = W^T . x^T (features x rows):
    // m64n64k16, A the pair's two blocks, B its rows of the staged x tile
    // (a product's predicate reads the stage's mask alone: one that read
    // the warpgroup's index made ptxas serialize every wgmma, C7520) ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int grp = tile % groups, n0 = tile / groups * TM;
      const int steps = __ldg(u_ptr + grp + 1) - __ldg(u_ptr + grp);
      float acc[PAIRS][32];
#pragma unroll
      for (int i = 0; i < PAIRS; ++i)
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[i][q] = 0.f;

      for (int s = 0; s < steps; ++s, ++it) {
        const int slot = it % STAGES;
        mbar_wait(full + slot, (it / STAGES) & 1);
        // the stage's present pairs, as the producer left them beside it
        const unsigned mask = slot_mask[slot];
        const uint32_t base = smem_addr(ring + slot * S::STAGE);
        const uint32_t xa = base + wg * 64 * XA * 2;
        const uint32_t wa = base + S::X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < XA / 16; ++ks) {
          // k16 step ks: B, 32 bytes along the x tile's 128-byte rows; A,
          // of half h's pairs (back to back in their order), k16 step kk
          const int h = ks / (B / 16), kk = ks % (B / 16);
          const uint64_t db = sw_desc<2 * XA>(xa + ks * 32, 16, 16 * XA);
#pragma unroll
          for (int m = 0; m < PAIRS; ++m) {
            const int e = h * PAIRS + m;
            if (mask >> e & 1) {
              const uint32_t a = wa + __popc(mask & ((1u << e) - 1)) * S::P_BYTES;
              // fprop: A = the blocks' transpose, M-major (a block's 32
              // columns a 64-byte row, the pair's second block one block
              // on); bprop: the blocks as stored, K-major (64 rows)
              const uint64_t da = TRANS ? sw_desc<2 * B>(a + kk * 32, 16, 16 * B)
                                        : sw_desc<2 * B>(a + kk * 32 * B, S::W_BYTES, 16 * B);
              wgmma<TRANS ? 0 : 1, 0>(acc[m], da, db, 1, T());
            }
          }
        }
        wgmma_commit();
        // this step's products done, its slot goes back
        wgmma_wait<0>();
        __syncwarp();
        if ((tid & 127) == 0) mbar_arrive(empty + slot);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) fence_regs(acc[i]);
      __syncwarp();

      // epilogue: every consumer is done with the staged tile of the last
      // one; this tile rounded once into it, transposed back to rows of
      // features (the ring already holds the next tile's stages), then
      // 16-byte rows of y, rows past N and column slots past the group's
      // last not written
      bar_sync(1, CONSUMERS);
#pragma unroll
      for (int m = 0; m < PAIRS; ++m) {
        // D's fragment: features f, f + 8 of rows 8c + 2 (lane % 4), + 1
        const int f = m * 64 + wq * 16 + (lane >> 2);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int row = wg * 64 + 8 * c + 2 * (lane & 3);
          put(os + row * OLD + f, acc[m][4 * c]);
          put(os + (row + 1) * OLD + f, acc[m][4 * c + 1]);
          put(os + row * OLD + f + 8, acc[m][4 * c + 2]);
          put(os + (row + 1) * OLD + f + 8, acc[m][4 * c + 3]);
        }
      }
      bar_sync(1, CONSUMERS);
      constexpr int CH = FEATURES / 8;  // 16-byte chunks of a staged row
      for (int c = tid; c < TM * CH; c += CONSUMERS) {
        const int row = c / CH, q = c % CH;
        const int col = __ldg(grp_col + grp * G + q * 8 / B);
        if (n0 + row < N && col >= 0)
          *reinterpret_cast<uint4*>(y + static_cast<size_t>(n0 + row) * K +
                                    static_cast<size_t>(col) * B + (q * 8) % B) =
              *reinterpret_cast<const uint4*>(os + row * OLD + q * 8);
      }
    }
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch(const void* x, const void* wp, const int* u_ptr, const int* u_in,
                   const int* u_pairs, const int* u_woff, const int* grp_col, void* y, int N,
                   int C, int K, int groups, cudaStream_t stream) {
  auto kernel = bsmm_xprop_sparse_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<B>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  // the map holds this call's address: encoded a call
  CUtensorMap xmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)C * sizeof(T)};
  const cuuint32_t xbox[2] = {XA, TM};
  err = tiled_map<T>(&xmap, x, 2, xdims, xstrides, xbox, 2 * XA);
  if (err != cudaSuccess) return err;
  // persistent: one thread block an SM walks the tiles
  const long long tiles = static_cast<long long>(groups) * ((N + TM - 1) / TM);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, bytes, stream>>>(xmap, static_cast<const T*>(wp), u_ptr, u_in, u_pairs,
                                           u_woff, grp_col, static_cast<T*>(y), N, K, groups);
  return cudaGetLastError();
}

// The weights packed for the kernel above (xprop_sparse_pack in
// kernels/bsmm.py; replaces no TPU kernel: the TPU kernels read the
// blocks where they lie): wp[e] = W[order[e]] (zeros where order[e] is
// -1: a pair's absent block), each 16-byte chunk c of a 32 x 32 block's
// row r moved to chunk c ^ (r / 2 % 4), where TMA's 64-byte swizzle would
// stage it.  One thread a 16-byte chunk; bound by bytes (each block it
// copies read once, every packed block written once).
__global__ void bsmm_xprop_sparse_pack_kernel(const uint4* __restrict__ w,
                                              const long long* __restrict__ order,
                                              uint4* __restrict__ wp, long long chunks) {
  constexpr int ROW = 4, BLOCK = 32 * ROW;  // 16-byte chunks a row, a block
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < chunks;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int rc = static_cast<int>(i % BLOCK), r = rc / ROW, c = rc % ROW;
    const long long src = __ldg(order + i / BLOCK);
    wp[i] = src < 0 ? make_uint4(0, 0, 0, 0) : w[src * BLOCK + r * ROW + (c ^ ((r >> 1) & 3))];
  }
}

// registers, local (spilled) bytes, dynamic shared memory, resident thread
// blocks an SM and ring slots of one instantiation
template <typename T, bool TRANS>
cudaError_t info_of(int* info) {
  auto kernel = bsmm_xprop_sparse_kernel<T, 32, TRANS>;
  constexpr size_t bytes = smem_bytes<32>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  cudaFuncAttributes at;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, bytes);
  if (err != cudaSuccess) return err;
  info[0] = at.numRegs;
  info[1] = static_cast<int>(at.localSizeBytes);
  info[2] = static_cast<int>(bytes);
  info[3] = blocks;
  info[4] = Cfg<32>::STAGES;
  return cudaSuccess;
}

#define SP_ARGS x, wp, u_ptr, u_in, u_pairs, u_woff, grp_col, y, N, C, K, groups, s

template <typename T>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* wp, const int* u_ptr,
                     const int* u_in, const int* u_pairs, const int* u_woff, const int* grp_col,
                     void* y, int N, int C, int K, int groups, cudaStream_t s) {
  if (bsize != 32) return cudaErrorInvalidValue;
  return trans_w ? launch<T, 32, true>(SP_ARGS) : launch<T, 32, false>(SP_ARGS);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; bsize 32; any other returns
// cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0 for fprop
// (W[w] is (in, out)), 1 for bprop (W[w]^T).  u_ptr (groups + 1), u_in,
// u_pairs and u_woff (items), grp_col (groups, 256 / bsize):
// xprop_sparse_plan's arrays over the CSR of y's block-columns; wp
// (w_order's length, bsize, bsize): the weight blocks w_order names, in
// its order (zeros for -1), each in the swizzled layout
// (xprop_sparse_pack).  x, wp and y 16-byte
// aligned, C and K multiples of 8, N >= 1.  Returns a cudaError_t (0 =
// launched).
extern "C" int bsmm_xprop_sparse_nc(int dtype, int bsize, int trans_w, const void* x,
                                    const void* wp, const int* u_ptr, const int* u_in,
                                    const int* u_pairs, const int* u_woff, const int* grp_col,
                                    void* y, int N, int C, int K, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || groups < 1) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans_w, SP_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans_w, SP_ARGS);
  return cudaErrorInvalidValue;
}

// dtype 1 (bf16) or 2 (f16), trans_w 0 or 1: info[0..4] = registers, local
// bytes, dynamic shared memory, resident thread blocks an SM, ring slots.
extern "C" int bsmm_xprop_sparse_info(int dtype, int trans_w, int* info) {
  if (dtype == 1)
    return trans_w ? info_of<__nv_bfloat16, true>(info) : info_of<__nv_bfloat16, false>(info);
  if (dtype == 2) return trans_w ? info_of<__half, true>(info) : info_of<__half, false>(info);
  return cudaErrorInvalidValue;
}

// bsize 32; w (blocks, 32, 32) and wp (entries, 32, 32) of a 16-bit type,
// 16-byte aligned; order (entries,) int64 block ids.  Returns a
// cudaError_t (0 = launched).
extern "C" int bsmm_xprop_sparse_pack_nc(int bsize, const void* w, const long long* order,
                                         void* wp, long long entries, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bsize != 32) return cudaErrorInvalidValue;
  const long long chunks = entries * 32 * 32 / 8;
  if (chunks < 1) return cudaSuccess;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long want = (chunks + 255) / 256, cap = 8LL * sms;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  const uint4* src = static_cast<const uint4*>(w);
  uint4* dst = static_cast<uint4*>(wp);
  bsmm_xprop_sparse_pack_kernel<<<grid, 256, 0, s>>>(src, order, dst, chunks);
  return cudaGetLastError();
}

#undef SP_ARGS
