// Block-sparse matmul xprop on Hopper's warpgroup tensor-core products
// (wgmma) fed by TMA, bf16 and f16, in the NC orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w).
// Block sizes 32, 64 and 128.  b8 and b16 stay on bsmm_xprop_mma.cu: their
// block rows (16 and 32 bytes) are narrower than a k16 step's 32 bytes or
// than the 64-byte swizzle this kernel stages in, and their layouts are not
// on the main path.
//
// Replaces, for bf16 and f16 inputs on the unsplit route, the TPU kernels
// xprop_pallas_dense_tile, xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py:1422, :507, :674, :158), as
// bsmm_xprop_mma.cu did before it; the route between the three unsplit
// kernels (xprop_kernel in kernels/bsmm.py) is a rule of shapes, the
// plan's counts and the SM count: where the tiles fill half the card, b32
// goes to bsmm_xprop_sparse.cu (faster here at every b32 shape measured,
// its x tile two input blocks of 128-byte rows and its weights one bulk
// copy a stage), b64 to this kernel, and b128 to this kernel where a
// staged x tile serves 3 or more columns on average.
// The split route (partial tiles, and the split fused over a cluster) stays
// on bsmm_xprop_mma.cu, so that its result stays bsmm_merge's over the
// partials bit for bit.
//
// Bound on the H100: at the LM's training shape (N = 16384, b32, 558 of
// 1,024 blocks, 512 -> 2048) a call is 18.7 GFLOP (0.019 ms of bf16
// tensor-core work) against 85 MB of inputs and outputs (0.0254 ms): bound
// by bytes.  bsmm_xprop_mma.cu gives one thread block one output
// block-column of an N-tile and so reads the x tile from L2 once per
// output column: N * blocks * B * 2 bytes, 585 MB a call at that shape.
//
// The design.  A tile is (an N-tile of TM = 128 rows, a group of G = 256 /
// B consecutive output block-columns: 256 output features).  The
// host plan (xprop_wgmma_plan in kernels/bsmm.py) lists each group's items:
// the union of its columns' input blocks in ascending order, each with a
// bit mask of the columns that hold an entry for it and those entries'
// weight blocks.  A tile walks its items; one ring stage is one item
// (and one 64-wide half of its contraction at b128): one TMA box of the x
// tile (TM x A, A = min(B, 64) columns) and one box of each present weight
// block ((A, A) of the (blocks, B, B) store), so x is staged once a group
// and not once a column: 128 of the 558 tile loads at that shape (134 MB
// through L2 instead of 585).  Each present (item, column) pair issues
// wgmma m64nAk16 into that column's accumulators; an absent one issues
// nothing, so no flops are spent on the group's empty blocks.
//
// Persistent and warp-specialised: one thread block an SM walks the tiles
// (tile blockIdx.x, then + gridDim.x, ...).  Two consumer warpgroups own 64
// rows of a tile each (256 output features of f32 accumulators in
// registers: 128 a thread); one producer warpgroup's first warp keeps the
// ring of STAGES slots full across tiles, so the next tile's loads overlap
// this one's epilogue (an empty and a full mbarrier a slot; a slot goes
// back to the producer once the products of the stage after it are
// issued; the producer warp reads an item's plan entries one item ahead,
// a lane a column, and gives its registers to the consumers by
// setmaxnreg).  Operands: x is K-major A (rows of A elements, 64- or
// 128-byte swizzled); W is the B operand read
// as stored, MN-major in fprop ((k, n), n contiguous) and K-major in bprop
// ((n, k)), both legal for 16-bit wgmma.  Rows past N arrive as zeros
// (TMA's out-of-bounds fill) and are not stored.
//
// Order: each output column sums its LUT entries in LUT order (the CSR's
// ascending input blocks, which the items follow), k16 step by k16 step,
// unrounded f32, rounded once at the epilogue; no atomics, so two runs give
// identical bits.  An empty column writes zeros.  The epilogue stages the
// tile in its own shared memory (the ring holds the next tile's stages by
// then) and writes y with 16-byte stores.
//
// What still bounds it: at the LM's shape it ran at ~4x the bound (the
// H100 runs in PERF.md).  At b32 each stage is a 128 x 32 x box and ~2-4
// weight boxes of 32 x 32: a 2 KB weight box cost an SM about what an
// 8 KB one did, and the m64n32k16 products ran well under the tensor
// cores' rate; bsmm_xprop_sparse.cu, which stages two input blocks a stage,
// its weights in one bulk copy and transposes the product (m64n64k16 a
// pair of columns), took 0.43-0.79x this kernel's time at every b32 shape
// measured, and the route rule sends b32 there.
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int TM = 128;                   // rows of N a tile holds
constexpr int FEATURES = 256;             // output features a group
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int RING = 144 * 1024;          // bytes of ring stages
constexpr int OLD = FEATURES + 8;         // a staged output row, elements
constexpr int OUT = TM * OLD * 2;         // bytes of the staged output tile

template <int B> struct Cfg {
  static constexpr int A = B < 64 ? B : 64;  // a box's columns (one swizzle row)
  static constexpr int SB = B / A;           // boxes along a block side
  static constexpr int G = FEATURES / B;     // output columns a group
  static constexpr int NACC = G * SB;        // accumulator sets of A columns
  static constexpr int X_BYTES = TM * A * 2;
  static constexpr int W_BYTES = A * A * 2;
  static constexpr int STAGE = X_BYTES + NACC * W_BYTES;
  static constexpr int STAGES = RING / STAGE;
  static_assert(STAGES >= 2 && STAGE % 1024 == 0, "ring stages");
};

template <int B>
constexpr size_t smem_bytes() {
  // 1 KB to align the ring to 1024 bytes, the ring, the staged output
  // tile, a full and an empty mbarrier a slot
  return 1024 + RING + OUT + 2 * Cfg<B>::STAGES * sizeof(uint64_t);
}

// x (N, C) through xmap, W (blocks, B, B) through wmap; group g: items
// u_ptr[g] .. u_ptr[g + 1] (input block u_in, column mask u_mask, weight
// block u_w[item * G + j] of column slot j), columns grp_col[g * G + j]
// (-1 past the last).  Tile t = (n-tile t / groups, group t % groups); the
// thread block walks tiles blockIdx.x, + gridDim.x, ... and writes y's
// tile of each.
template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
bsmm_xprop_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const int* __restrict__ u_ptr,
                        const int* __restrict__ u_in, const int* __restrict__ u_mask,
                        const int* __restrict__ u_w, const int* __restrict__ grp_col,
                        T* __restrict__ y, int N, int K, int groups) {
  using S = Cfg<B>;
  constexpr int A = S::A, SB = S::SB, G = S::G, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  T* os = reinterpret_cast<T*>(ring + RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING + OUT);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // the groups of one N-tile run fastest: the tiles in flight read a few
  // x tiles, which come from device memory about once
  const int tiles = groups * ((N + TM - 1) / TM);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: the first warp keeps the ring full, tile after tile
    // (the next tile's loads overlap this one's epilogue).  Its lanes read
    // an item's plan entries together (lane j column slot j's weight
    // block), one item ahead of the loads; lane 0 issues the loads ----
    setmaxnreg_dec<40>();
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      int it = 0;  // ring steps so far: slot it % STAGES, round it / STAGES
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int grp = tile % groups, n0 = tile / groups * TM;
        const int t0 = __ldg(u_ptr + grp), items = __ldg(u_ptr + grp + 1) - t0;
        int mask = 0, in = 0, wb = 0;
        auto fetch = [&](int t) {
          mask = __ldg(u_mask + t);
          in = __ldg(u_in + t);
          wb = lane < G ? __ldg(u_w + static_cast<size_t>(t) * G + lane) : 0;
        };
        if (items > 0) fetch(t0);
        for (int i = 0; i < items; ++i) {
          const int cur_mask = mask, cur_in = in, cur_wb = wb;
          if (i + 1 < items) fetch(t0 + i + 1);
          for (int kh = 0; kh < SB; ++kh, ++it) {
            const int slot = it % STAGES;
            mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
            unsigned char* st = ring + slot * S::STAGE;
            if (lane == 0) {
              mbar_expect_tx(full + slot, S::X_BYTES + __popc(cur_mask) * SB * S::W_BYTES);
              tma_load_2d(st, &xmap, full + slot, cur_in * B + kh * A, n0);
            }
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const int w = __shfl_sync(0xffffffffu, cur_wb, j);
              if (lane == 0 && (cur_mask >> j & 1)) {
#pragma unroll
                for (int nh = 0; nh < SB; ++nh) {
                  unsigned char* dst = st + S::X_BYTES + (j * SB + nh) * S::W_BYTES;
                  // the box of W[w] at (column, row): fprop rows k,
                  // columns n; bprop rows n, columns k
                  if (TRANS)
                    tma_load_3d(dst, &wmap, full + slot, kh * A, nh * A, w);
                  else
                    tma_load_3d(dst, &wmap, full + slot, nh * A, kh * A, w);
                }
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 .. of each tile ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2), tg = lane & 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int grp = tile % groups, n0 = tile / groups * TM;
      const int t0 = __ldg(u_ptr + grp);
      const int steps = (__ldg(u_ptr + grp + 1) - t0) * SB;
      float acc[S::NACC][A / 2];
#pragma unroll
      for (int i = 0; i < S::NACC; ++i)
#pragma unroll
        for (int q = 0; q < A / 2; ++q) acc[i][q] = 0.f;

      for (int s = 0; s < steps; ++s, ++it) {
        const int slot = it % STAGES;
        const int mask = __ldg(u_mask + t0 + s / SB);
        mbar_wait(full + slot, (it / STAGES) & 1);
        const uint32_t base = smem_addr(ring + slot * S::STAGE);
        const uint32_t xa = base + wg * 64 * A * 2;
        const uint32_t wa = base + S::X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < A / 16; ++ks) {
          // k16 step ks: 32 bytes along a K-major row, 16 rows of an
          // MN-major tile
          const uint64_t da = sw_desc<2 * A>(xa + ks * 32, 16, 16 * A);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            if (mask >> j & 1) {
#pragma unroll
              for (int nh = 0; nh < SB; ++nh) {
                const uint32_t wt = wa + (j * SB + nh) * S::W_BYTES;
                const uint64_t db = TRANS ? sw_desc<2 * A>(wt + ks * 32, 16, 16 * A)
                                          : sw_desc<2 * A>(wt + ks * 32 * A, 16 * A, 16 * A);
                wgmma<0, TRANS ? 0 : 1>(acc[j * SB + nh], da, db, 1, T());
              }
            }
          }
        }
        wgmma_commit();
        // the products of the step before are done: the producer may
        // refill its slot (this step's stay in flight)
        wgmma_wait<1>();
        __syncwarp();
        if (s > 0 && lane == 0) mbar_arrive(empty + (it + STAGES - 1) % STAGES);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) fence_regs(acc[i]);
      __syncwarp();
      if (steps > 0 && lane == 0) mbar_arrive(empty + (it + STAGES - 1) % STAGES);

      // epilogue: every consumer is done with the staged tile of the last
      // one; this tile rounded once into it (the ring already holds the
      // next tile's stages), then 16-byte rows of y, rows past N and
      // column slots past the group's last not written
      bar_sync(1, CONSUMERS);
#pragma unroll
      for (int i = 0; i < S::NACC; ++i)
#pragma unroll
        for (int jn = 0; jn < A / 8; ++jn) {
          const int c = i * A + jn * 8 + tg * 2;
          store2(os + r * OLD + c, acc[i][4 * jn], acc[i][4 * jn + 1]);
          store2(os + (r + 8) * OLD + c, acc[i][4 * jn + 2], acc[i][4 * jn + 3]);
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
cudaError_t launch(const void* x, const void* w, const int* u_ptr, const int* u_in,
                   const int* u_mask, const int* u_w, const int* grp_col, void* y, int N, int C,
                   int K, int groups, int w_blocks, cudaStream_t stream) {
  using S = Cfg<B>;
  auto kernel = bsmm_xprop_wgmma_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<B>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters, so a replay reads the captured tensors)
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)C * sizeof(T)};
  const cuuint32_t xbox[2] = {S::A, TM};
  err = tiled_map<T>(&xmap, x, 2, xdims, xstrides, xbox, 2 * S::A);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {B, B, (cuuint64_t)w_blocks};
  const cuuint64_t wstrides[2] = {B * sizeof(T), (cuuint64_t)B * B * sizeof(T)};
  const cuuint32_t wbox[3] = {S::A, S::A, 1};
  err = tiled_map<T>(&wmap, w, 3, wdims, wstrides, wbox, 2 * S::A);
  if (err != cudaSuccess) return err;
  // persistent: one thread block an SM walks the tiles
  const long long tiles = static_cast<long long>(groups) * ((N + TM - 1) / TM);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, bytes, stream>>>(xmap, wmap, u_ptr, u_in, u_mask, u_w, grp_col,
                                           static_cast<T*>(y), N, K, groups);
  return cudaGetLastError();
}

#define WG_ARGS x, w, u_ptr, u_in, u_mask, u_w, grp_col, y, N, C, K, groups, w_blocks, s

template <typename T>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w, const int* u_ptr,
                     const int* u_in, const int* u_mask, const int* u_w, const int* grp_col,
                     void* y, int N, int C, int K, int groups, int w_blocks, cudaStream_t s) {
  switch (bsize) {
    case 32: return trans_w ? launch<T, 32, true>(WG_ARGS) : launch<T, 32, false>(WG_ARGS);
    case 64: return trans_w ? launch<T, 64, true>(WG_ARGS) : launch<T, 64, false>(WG_ARGS);
    case 128: return trans_w ? launch<T, 128, true>(WG_ARGS) : launch<T, 128, false>(WG_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; bsize 32, 64 or 128; any other returns
// cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0 for fprop
// (W[w] is (in, out)), 1 for bprop (W[w]^T); w (w_blocks, bsize, bsize).
// u_ptr (groups + 1), u_in and u_mask (items), u_w (items, 256 / bsize),
// grp_col (groups, 256 / bsize): xprop_wgmma_plan's arrays over the CSR of
// y's block-columns.  x, w and y 16-byte aligned, C and K multiples of 8,
// N >= 1.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_xprop_wgmma_nc(int dtype, int bsize, int trans_w, const void* x,
                                   const void* w, const int* u_ptr, const int* u_in,
                                   const int* u_mask, const int* u_w, const int* grp_col,
                                   void* y, int N, int C, int K, int groups, int w_blocks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || groups < 1) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans_w, WG_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans_w, WG_ARGS);
  return cudaErrorInvalidValue;
}

#undef WG_ARGS
