// Block-sparse matmul xprop for small blocks (b 8, 16, 32) in 128-deep
// chunks on Hopper's warpgroup tensor-core products (wgmma), x fed by TMA,
// bf16 and f16, NC orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w).
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_fine
// (blocksparse_tpu/kernels/bsmm.py:2294, body _xprop_fine_kernel), which
// gathers Gf = 128/b LUT entries of one output block-column into one
// 128-deep MXU contraction, where the route rule (fine_kernel in
// kernels/bsmm.py) picks it; bsmm_fine_mma.cu (mma.sync) keeps the other
// shapes and bsmm_fine.cu the f32 inputs.  The plan is fine_plan's
// (chunk_ptr; slot_in, slot_w: a chunk's GF slots' input and weight
// blocks, -1 past the column's last entry).
//
// Bound on the H100: at the canonical small-block bench row (hidden 7680,
// b8, 105,178 blocks, N = 64) a call is 0.86 GFLOP (0.0009 ms of bf16
// tensor-core work) against 15 MB of inputs and outputs (0.0046 ms): bound
// by bytes.  A chunk gathers x once per entry (N x b elements: 108 MB
// through L2 at b8, 54 at b16, 28 at b32) beside W's 13.5 MB, in pieces
// of 16 (b8) to 64 (b32) bytes a row; bsmm_fine_mma.cu spent its time on
// the latency of each thread block's short chain of dependent gathers.
//
// The design: persistent thread blocks (two an SM) walk the items (N-tile
// of 64 rows, output column o; the columns of one N-tile run fastest, so
// the blocks in flight gather from a few x rows hot in L2) in plan order.
// Four producer warps keep a ring of chunks in flight (STAGES of them,
// across items; warp p takes every fourth chunk, so four chains of
// dependent reads overlap): a slot's (64 rows x b) slice of x lands by
// one TMA box of a 2-d map over x, in the swizzle wgmma reads a K-major
// tile of b-element rows in (none at b8, 32-byte at b16, 64-byte at b32),
// so no thread computes a gather address and no ldmatrix runs; the
// chunk's weights (its GF blocks as B: in fprop the blocks' rows stacked,
// MN-major in the swizzle of their b * 2-byte rows; in bprop K-major, two
// 128-byte swizzled panels of 64 inputs) the warp copies itself, 16 bytes
// a lane, from the blocks where they lie (zeros for an absent slot), then
// fences them for the tensor cores' reads: no packed copy a call (a pack
// kernel and one bulk copy a chunk measured 0.0096 ms more a call at the
// canonical b8 row, the NVIDIA H100 run in PERF.md).  One consumer
// warpgroup runs a chunk's k16 steps as m64nBk16 products, x rows on
// wgmma's M (the transposed form, output features on M over a group of
// columns, would need the group's columns to share their input blocks: a
// fine chunk's do not), then hands the slot back.  Only a chunk's present
// slots are staged and multiplied; at b8 a k16 step takes two slots, and
// an odd last slot pairs with a box of rows past N, which TMA fills with
// zeros.  The epilogue stages the tile in shared memory and writes y in
// 16-byte rows, rounded once.  An empty column writes zeros.  No atomics:
// each output's sum runs chunk by chunk, k16 step by k16 step, in LUT
// order, so two runs give identical bits.  No zero block is multiplied
// with x: a non-finite input spreads as in the plain version.
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int TM = 64;                    // rows of N an item (wgmma's M)
constexpr int DEPTH = 128;                // contraction rows a chunk
constexpr int CONSUMERS = 128;            // one consumer warpgroup
constexpr int PRODUCERS = 4;              // producer warps
constexpr int THREADS = CONSUMERS + 32 * PRODUCERS;
constexpr int RING = 100 * 1024;          // bytes of ring stages (two blocks an SM)
constexpr int BLOCKS_PER_SM = 2;

template <int B> struct FineCfg {
  static_assert(B == 8 || B == 16 || B == 32, "block size 8, 16 or 32");
  static constexpr int GF = DEPTH / B;         // slots a chunk
  static constexpr int X_SLOT = TM * B * 2;    // one slot's x box
  static constexpr int X_BYTES = GF * X_SLOT;  // 16 KB
  static constexpr int W_BYTES = DEPTH * B * 2;
  static constexpr int WQ = W_BYTES / 16 / 32; // 16-byte pieces of W a lane
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES = RING / STAGE;
  static constexpr int SW = B * 2;             // x's and fprop W's row bytes and swizzle
  static constexpr int OLD = B + 8;            // a staged output row, elements
  static constexpr int OUT = TM * OLD * 2;
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "ring stages");
};

template <int B>
constexpr size_t smem_bytes() {
  // 1 KB to align the ring, the ring, the staged output tile, a full and
  // an empty mbarrier and the consumers' mask of k16 steps a slot
  using S = FineCfg<B>;
  return 1024 + RING + S::OUT + S::STAGES * (2 * sizeof(uint64_t) + sizeof(int));
}

// Where 16-byte piece q of a chunk's staged weights comes from: the slot
// (block) and the piece's offset in that block, in elements.  fprop: rows
// k of B elements (MN-major), piece c of row r at c ^ (the row's swizzle);
// bprop: panel q / (8B) of 64 k, rows n, piece c at c ^ (n % 8).
template <int B, bool TRANS>
__device__ __forceinline__ void w_piece(int q, int& slot, int& off) {
  if constexpr (TRANS) {
    const int n = (q % (B * 8)) >> 3;
    const int k0 = (q / (B * 8)) * 64 + (((q & 7) ^ (n & 7)) << 3);
    slot = k0 / B;
    off = n * B + k0 % B;
  } else {
    constexpr int RCH = B / 8;                 // pieces a row
    const int r = q / RCH;
    const int c = (q % RCH) ^ (((r * B * 2) >> 7) & (RCH - 1));
    slot = r / B;
    off = (r % B) * B + c * 8;
  }
}

// x (N, C) through xmap (boxes of B x TM); w the layout's blocks; item t:
// column t % n_out, rows (t / n_out) * TM ..; the thread block walks t =
// blockIdx.x, + gridDim.x, ...
template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
bsmm_fine_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
                       const int* __restrict__ chunk_ptr, const int* __restrict__ slot_in,
                       const int* __restrict__ slot_w, T* __restrict__ y, int N, int K) {
  using S = FineCfg<B>;
  constexpr int GF = S::GF, STAGES = S::STAGES, OLD = S::OLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  T* os = reinterpret_cast<T*>(ring + RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING + S::OUT);
  uint64_t* empty = full + STAGES;
  volatile unsigned* slot_steps = reinterpret_cast<volatile unsigned*>(empty + STAGES);

  const int tid = threadIdx.x;
  const int n_out = K / B;
  const int items = n_out * ((N + TM - 1) / TM);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: warp pw stages chunks it % PRODUCERS == pw.  Lane l
    // reads slot l of the chunk and its WQ pieces of the weights (before
    // the slot is free); then the pieces go into the slot, fenced for the
    // async proxy, lane 0 hands the present slots' k16 steps to the consumers
    // and arrives with the x boxes' bytes, and each lane issues its slot's
    // box ----
    const int lane = tid & 31, pw = (tid - CONSUMERS) >> 5;
    int it = 0;  // ring steps so far: slot it % STAGES, round it / STAGES
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int o = item % n_out, n0 = item / n_out * TM;
      const int c1 = __ldg(chunk_ptr + o + 1);
      for (int c = __ldg(chunk_ptr + o); c < c1; ++c, ++it) {
        if (it % PRODUCERS != pw) continue;
        const size_t cs = static_cast<size_t>(c) * GF;
        const int in = lane < GF ? __ldg(slot_in + cs + lane) : -1;
        const int wid = lane < GF ? __ldg(slot_w + cs + lane) : -1;
        const int nv = __popc(__ballot_sync(0xffffffffu, in >= 0));
        const int boxes = B == 8 ? (nv + 1) & ~1 : nv;  // b8: whole k16 steps
        uint4 v[S::WQ];
#pragma unroll
        for (int j = 0; j < S::WQ; ++j) {
          int slot, off;
          w_piece<B, TRANS>(lane + 32 * j, slot, off);
          const int id = __shfl_sync(0xffffffffu, wid, slot);
          v[j] = id >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                               w + static_cast<size_t>(id) * B * B + off))
                         : make_uint4(0, 0, 0, 0);
        }
        const int slot = it % STAGES;
        mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
        unsigned char* st = ring + slot * S::STAGE;
        uint4* ws = reinterpret_cast<uint4*>(st + S::X_BYTES);
#pragma unroll
        for (int j = 0; j < S::WQ; ++j) ws[lane + 32 * j] = v[j];
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          // bit t: k16 step t multiplies present slots
          slot_steps[slot] = (1u << (boxes * B / 16)) - 1;
          mbar_expect_tx(full + slot, boxes * S::X_SLOT);
        }
        __syncwarp();
        // a padding slot reads rows past N: a box of zeros
        if (lane < boxes)
          tma_load_2d(st + lane * S::X_SLOT, &xmap, full + slot, in >= 0 ? in * B : 0,
                      in >= 0 ? n0 : N);
      }
    }
  } else {
    // ---- consumers: D (64 rows x B features) += x slots . W chunk, k16
    // step by k16 step; a product's predicate reads the stage's step mask
    // alone, and the accumulators are read on no divergent path (either
    // would serialize the wgmma, ptxas C7520) ----
    // (the warpgroup's register cut is also where ptxas learns that its
    // four warps run together: without it every wgmma was serialized)
    setmaxnreg_dec<64>();
    const int warp = tid >> 5, lane = tid & 31;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int o = item % n_out, n0 = item / n_out * TM;
      const int chunks = __ldg(chunk_ptr + o + 1) - __ldg(chunk_ptr + o);
      float acc[B / 2];
#pragma unroll
      for (int q = 0; q < B / 2; ++q) acc[q] = 0.f;
      for (int s = 0; s < chunks; ++s, ++it) {
        const int slot = it % STAGES;
        mbar_wait(full + slot, (it / STAGES) & 1);
        const unsigned steps = slot_steps[slot];
        const uint32_t xa = smem_addr(ring + slot * S::STAGE);
        const uint32_t wa = xa + S::X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < DEPTH / 16; ++t) {
          if (steps >> t & 1) {
            // A: the x slots of k16 step t (b8: slots 2t, 2t + 1, a box
            // apart; b16: slot t; b32: half t % 2 of slot t / 2)
            uint64_t da;
            if constexpr (B == 8)
              da = sw_desc<16>(xa + 2 * t * S::X_SLOT, S::X_SLOT, 128);
            else if constexpr (B == 16)
              da = sw_desc<32>(xa + t * S::X_SLOT, 16, 256);
            else
              da = sw_desc<64>(xa + (t >> 1) * S::X_SLOT + (t & 1) * 32, 16, 512);
            // B: k16 step t of the staged weights; fprop: 16 rows of k
            // (8-k groups 8 rows apart, both offsets so: one atom along
            // n), bprop: 32 bytes along a 128-byte panel row
            uint64_t db;
            if constexpr (TRANS)
              db = sw_desc<128>(wa + (t >> 2) * B * 128 + (t & 3) * 32, 16, 1024);
            else
              db = sw_desc<S::SW>(wa + t * 16 * S::SW, 8 * S::SW, 8 * S::SW);
            wgmma<0, TRANS ? 0 : 1>(acc, da, db, 1, T());
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        __syncwarp();
        if (tid == 0) mbar_arrive(empty + slot);
      }
      fence_regs(acc);
      // epilogue: the tile through shared memory (the last item's rows
      // written out first), then 16-byte rows of y, rows past N not written
      bar_sync(1, CONSUMERS);
#pragma unroll
      for (int j = 0; j < B / 8; ++j) {
        const int r = warp * 16 + (lane >> 2), col = j * 8 + 2 * (lane & 3);
        store2(os + r * OLD + col, acc[4 * j], acc[4 * j + 1]);
        store2(os + (r + 8) * OLD + col, acc[4 * j + 2], acc[4 * j + 3]);
      }
      bar_sync(1, CONSUMERS);
      for (int q = tid; q < TM * (B / 8); q += CONSUMERS) {
        const int r = q / (B / 8), c = q % (B / 8);
        if (n0 + r < N)
          *reinterpret_cast<uint4*>(y + static_cast<size_t>(n0 + r) * K +
                                    static_cast<size_t>(o) * B + c * 8) =
              *reinterpret_cast<const uint4*>(os + r * OLD + c * 8);
      }
    }
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch(const void* x, const void* w, const int* chunk_ptr, const int* slot_in,
                   const int* slot_w, void* y, int N, int C, int K, cudaStream_t stream) {
  auto kernel = bsmm_fine_wgmma_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<B>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  // the map holds this call's address: encoded a call
  CUtensorMap xmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)C * sizeof(T)};
  const cuuint32_t xbox[2] = {B, TM};
  err = tiled_map<T>(&xmap, x, 2, xdims, xstrides, xbox, FineCfg<B>::SW);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(K / B) * ((N + TM - 1) / TM);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long cap = static_cast<long long>(BLOCKS_PER_SM) * sms;
  const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
  kernel<<<grid, THREADS, bytes, stream>>>(xmap, static_cast<const T*>(w), chunk_ptr, slot_in,
                                           slot_w, static_cast<T*>(y), N, K);
  return cudaGetLastError();
}

template <typename T, int B, bool TRANS>
cudaError_t info_of(int* info) {
  auto kernel = bsmm_fine_wgmma_kernel<T, B, TRANS>;
  constexpr size_t bytes = smem_bytes<B>();
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
  info[4] = FineCfg<B>::STAGES;
  return cudaSuccess;
}

#define FINE_ARGS x, w, chunk_ptr, slot_in, slot_w, y, N, C, K, s

template <typename T, int B>
cudaError_t launch_dir(int trans_w, const void* x, const void* w, const int* chunk_ptr,
                       const int* slot_in, const int* slot_w, void* y, int N, int C, int K,
                       cudaStream_t s) {
  return trans_w ? launch<T, B, true>(FINE_ARGS) : launch<T, B, false>(FINE_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w,
                     const int* chunk_ptr, const int* slot_in, const int* slot_w, void* y,
                     int N, int C, int K, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch_dir<T, 8>(trans_w, FINE_ARGS);
    case 16: return launch_dir<T, 16>(trans_w, FINE_ARGS);
    case 32: return launch_dir<T, 32>(trans_w, FINE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int B>
cudaError_t info_dir(int trans_w, int* info) {
  return trans_w ? info_of<T, B, true>(info) : info_of<T, B, false>(info);
}

template <typename T>
cudaError_t info_dispatch(int bsize, int trans_w, int* info) {
  switch (bsize) {
    case 8: return info_dir<T, 8>(trans_w, info);
    case 16: return info_dir<T, 16>(trans_w, info);
    case 32: return info_dir<T, 32>(trans_w, info);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bsmm_fine.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any other
// dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0
// for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  bsize 8, 16 or 32.
// chunk_ptr (K / bsize + 1), slot_in and slot_w (chunks, 128 / bsize):
// fine_plan's.  x, w and y 16-byte aligned, C and K multiples of 8, N >=
// 1.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_fine_wgmma_nc(int dtype, int bsize, int trans_w, const void* x,
                                  const void* w, const int* chunk_ptr, const int* slot_in,
                                  const int* slot_w, void* y, int N, int C, int K,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans_w, FINE_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans_w, FINE_ARGS);
  return cudaErrorInvalidValue;
}

// dtype 1 (bf16) or 2 (f16), bsize 8, 16 or 32, trans_w 0 or 1: info[0..4]
// = registers, local bytes, dynamic shared memory, resident thread blocks
// an SM, ring slots.
extern "C" int bsmm_fine_wgmma_info(int dtype, int bsize, int trans_w, int* info) {
  if (dtype == 1) return info_dispatch<__nv_bfloat16>(bsize, trans_w, info);
  if (dtype == 2) return info_dispatch<__half>(bsize, trans_w, info);
  return cudaErrorInvalidValue;
}

#undef FINE_ARGS
