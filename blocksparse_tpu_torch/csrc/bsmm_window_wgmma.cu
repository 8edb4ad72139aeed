// Block-sparse matmul xprop with x staged once per window for a group of
// output columns whose accumulators stay resident, on Hopper's warpgroup
// tensor-core products (wgmma) fed by TMA and bulk copies, bf16 and f16,
// NC orientation (feature_axis=1), block sizes 8-128:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w).
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_window
// (blocksparse_tpu/kernels/bsmm.py:1800, body _xprop_window_kernel): a
// super-group of output columns keeps its f32 accumulators resident while
// x is streamed once per column window, where the route rule
// (window_kernel in kernels/bsmm.py) picks it; bsmm_window_mma.cu
// (mma.sync) keeps the other shapes and bsmm_window.cu the f32 inputs.
//
// Bound on the H100: at the window's regime (bench.py's random 8192^2,
// b32, d 0.25, 16,784 blocks) a call is 8.8 GFLOP at N 256 and 70 at N
// 2048 (0.009 / 0.071 ms of bf16 tensor-core work) against 43 / 101 MB of
// inputs and outputs (0.013 / 0.030 ms).  bsmm_window_mma.cu read x
// through L2 once per super-group (134 MB / 1.07 GB) and W once per
// N-tile, which its N-tile rule cut to 32 rows at N 256 to fill the SMs
// (275 MB), with 16-byte cp.async copies and ldmatrix fragments for
// mma.sync m16n8k16: 1.9x a dense torch.matmul at N 256 and 1.7x at 2048.
//
// The design (window_wgmma_plan in kernels/bsmm.py): a group is 256
// output features (256 / b block-columns; at b128 two), four m64 slots of
// 64 features; a window is 64 input features, one x box.  An item is a
// window that holds entries of the group; its cells are the present
// (k-block, m-slot) tiles of 64 features x KD inputs (KD = 16 at b8 and
// b16, 32 at b32, 64 at b64 and b128; at b8 and b16 a cell spans several
// columns' blocks, at b128 a quarter of one), which the pack kernel below
// lays out once a call in plan order, each K-major in the swizzle of its
// KD * 2-byte rows (zeros for a block a cell spans but the layout lacks).
// Persistent thread blocks, one an SM, walk the tiles (N-tile of 128 rows,
// group; the groups of one N-tile run fastest; the route rule takes this
// kernel only where they fill the card).  One producer warp keeps
// a ring of STAGES stages full: a stage is one item, its x box (TN rows x
// 64 features, 128-byte swizzled, one TMA load) and its cells (one bulk
// copy).  Two consumer warpgroups each own TN / 2 rows of the tile for
// every m-slot of the group, the product transposed: D = W^T . x^T
// (features x rows), one m64n64k16 a present cell and k16 step, A the
// cell, B the warpgroup's rows of the x box.  The f32 accumulators (four
// m-slots) stay in registers over all of the tile's items.  The epilogue
// transposes D back through shared memory and writes 16-byte rows of y,
// each output once, rounded once.  An empty column writes zeros.
//
// Order: each output sums its entries window by window, k-block by
// k-block (ascending inputs: LUT order), k16 step by k16 step, in f32; no
// atomics, so two runs give identical bits.  A cell also multiplies the
// zero blocks of the columns it spans: an infinity or a NaN in x meets
// them and turns those columns' outputs in its row to NaN where the plain
// version skips the block (a non-finite input is never hidden, only spread
// to more outputs).
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int FEATURES = 256;             // output features a group
constexpr int MSLOTS = FEATURES / 64;     // its m64 slots
constexpr int XA = 64;                    // input features a window (128-byte rows)
constexpr int TN = 128;                   // rows of N a tile
constexpr int NW = TN / 2;                // rows a consumer warpgroup
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int RING = 144 * 1024;          // bytes of ring stages
constexpr int OLD = FEATURES + 8;         // a staged output row, elements

// KD: input features a cell (its rows KD * 2 bytes, its swizzle); KBW:
// k-blocks a window
template <int KD> struct Cfg {
  static_assert(KD == 16 || KD == 32 || KD == 64, "cell depth 16, 32 or 64");
  static constexpr int KBW = XA / KD;
  static constexpr int X_BYTES = TN * XA * 2;
  static constexpr int CELL = 64 * KD * 2;
  static constexpr int STAGE = X_BYTES + KBW * MSLOTS * CELL;  // every cell present
  static constexpr int STAGES = RING / STAGE;
  static constexpr int OUT = TN * OLD * 2;          // the staged output tile
  static_assert(STAGES >= 3 && STAGE % 1024 == 0, "ring stages");
};

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

template <int KD>
constexpr size_t smem_bytes() {
  // 1 KB to align the ring, the ring, the staged output tile, a full and
  // an empty mbarrier and the consumers' cell mask a slot
  using S = Cfg<KD>;
  return 1024 + RING + S::OUT + S::STAGES * (2 * sizeof(uint64_t) + sizeof(int));
}

// x (N, C) through xmap (boxes of XA x TN); wp: the packed cells; group g:
// items u_ptr[g] .. u_ptr[g + 1] (u_in: the item's window, its x columns
// from u_in * XA; u_mask: bit q * MSLOTS + s for a present cell of
// k-block q, m-slot s; its cells wp[u_woff[item]] .., in bit order).  Tile
// t = (N-tile t / groups, group t % groups); the thread block walks t =
// blockIdx.x, + gridDim.x, ...
template <typename T, int KD>
__global__ void __launch_bounds__(THREADS, 1)
bsmm_window_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ wp,
                         const int* __restrict__ u_ptr, const int* __restrict__ u_in,
                         const int* __restrict__ u_mask, const int* __restrict__ u_woff,
                         T* __restrict__ y, int N, int K, int groups) {
  using S = Cfg<KD>;
  constexpr int KBW = S::KBW, STAGES = S::STAGES;
  constexpr int ACC = NW / 2;                       // accumulators a thread a m-slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  T* os = reinterpret_cast<T*>(ring + RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING + S::OUT);
  uint64_t* empty = full + STAGES;
  volatile unsigned* slot_mask = reinterpret_cast<volatile unsigned*>(empty + STAGES);

  const int tid = threadIdx.x;
  const int tiles = groups * ((N + TN - 1) / TN);

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
    // next batch's, read a batch ahead; lane 0 hands each stage's cell
    // mask to the consumers and issues its x box and its one bulk copy ----
    setmaxnreg_dec<40>();
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      int it = 0;  // ring steps so far: slot it % STAGES, round it / STAGES
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int grp = tile % groups, n0 = tile / groups * TN;
        const int t0 = __ldg(u_ptr + grp), t1 = __ldg(u_ptr + grp + 1);
        auto fetch = [&](int t, int& m, int& in, int& off) {
          if (t + lane < t1) {
            m = __ldg(u_mask + t + lane);
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
              const unsigned wbytes = __popc(mask) * S::CELL;
              slot_mask[slot] = mask;
              mbar_expect_tx(full + slot, S::X_BYTES + wbytes);
              tma_load_2d(st, &xmap, full + slot, in * XA, n0);
              bulk_load(st + S::X_BYTES, wp + static_cast<size_t>(off) * 64 * KD, wbytes,
                        full + slot);
            }
          }
          m0 = m1, in0 = in1, off0 = off1;
          fetch(b0 + 64, m1, in1, off1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * NW .. of each tile, for
    // every m-slot of the group, as D = W^T . x^T (features x rows):
    // m64n64k16, A the cell, B its rows of the staged x box (a
    // product's predicate reads the stage's mask alone: one that read the
    // warpgroup's index would serialize every wgmma, ptxas C7520) ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int grp = tile % groups, n0 = tile / groups * TN;
      const int steps = __ldg(u_ptr + grp + 1) - __ldg(u_ptr + grp);
      float acc[MSLOTS][ACC];
#pragma unroll
      for (int i = 0; i < MSLOTS; ++i)
#pragma unroll
        for (int q = 0; q < ACC; ++q) acc[i][q] = 0.f;

      for (int s = 0; s < steps; ++s, ++it) {
        const int slot = it % STAGES;
        mbar_wait(full + slot, (it / STAGES) & 1);
        // the stage's present cells, as the producer left them beside it
        const unsigned mask = slot_mask[slot];
        const uint32_t base = smem_addr(ring + slot * S::STAGE);
        const uint32_t xa = base + wg * NW * XA * 2;
        const uint32_t wa = base + S::X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < KBW; ++q) {
#pragma unroll
          for (int t = 0; t < KD / 16; ++t) {
            // B: k16 step t of k-block q, 32 bytes along the box's rows
            const uint64_t db = sw_desc<2 * XA>(xa + (q * KD + t * 16) * 2, 16, 16 * XA);
#pragma unroll
            for (int m = 0; m < MSLOTS; ++m) {
              const int e = q * MSLOTS + m;
              if (mask >> e & 1) {
                // A: the cell, K-major in KD * 2-byte swizzled rows
                const uint32_t a = wa + __popc(mask & ((1u << e) - 1)) * S::CELL;
                const uint64_t da = sw_desc<2 * KD>(a + t * 32, 16, 16 * KD);
                wgmma<0, 0>(acc[m], da, db, 1, T());
              }
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
      for (int i = 0; i < MSLOTS; ++i) fence_regs(acc[i]);
      __syncwarp();

      // epilogue: every consumer is done with the staged tile of the last
      // one; this tile rounded once into it, transposed back to rows of
      // features (the ring already holds the next tile's stages), then
      // 16-byte rows of y, rows past N and features past K not written
      bar_sync(1, CONSUMERS);
#pragma unroll
      for (int m = 0; m < MSLOTS; ++m) {
        // D's fragment: features f, f + 8 of rows 8c + 2 (lane % 4), + 1
        const int f = m * 64 + wq * 16 + (lane >> 2);
#pragma unroll
        for (int c = 0; c < NW / 8; ++c) {
          const int row = wg * NW + 8 * c + 2 * (lane & 3);
          put(os + row * OLD + f, acc[m][4 * c]);
          put(os + (row + 1) * OLD + f, acc[m][4 * c + 1]);
          put(os + row * OLD + f + 8, acc[m][4 * c + 2]);
          put(os + (row + 1) * OLD + f + 8, acc[m][4 * c + 3]);
        }
      }
      bar_sync(1, CONSUMERS);
      constexpr int CH = FEATURES / 8;  // 16-byte chunks of a staged row
      for (int c = tid; c < TN * CH; c += CONSUMERS) {
        const int row = c / CH, q = c % CH;
        const int col = grp * FEATURES + q * 8;
        if (n0 + row < N && col < K)
          *reinterpret_cast<uint4*>(y + static_cast<size_t>(n0 + row) * K + col) =
              *reinterpret_cast<const uint4*>(os + row * OLD + q * 8);
      }
    }
  }
}

template <typename T, int KD>
cudaError_t launch(const void* x, const void* wp, const int* u_ptr, const int* u_in,
                   const int* u_mask, const int* u_woff, void* y, int N, int C, int K,
                   int groups, cudaStream_t stream) {
  auto kernel = bsmm_window_wgmma_kernel<T, KD>;
  constexpr size_t bytes = smem_bytes<KD>();
  static_assert(bytes <= 232448, "shared memory of one thread block");
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  // the map holds this call's address: encoded a call
  CUtensorMap xmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t xstrides[1] = {(cuuint64_t)C * sizeof(T)};
  const cuuint32_t xbox[2] = {XA, TN};
  err = tiled_map<T>(&xmap, x, 2, xdims, xstrides, xbox, 2 * XA);
  if (err != cudaSuccess) return err;
  // persistent: one thread block an SM walks the tiles
  const long long tiles = static_cast<long long>(groups) * ((N + TN - 1) / TN);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, bytes, stream>>>(xmap, static_cast<const T*>(wp), u_ptr, u_in, u_mask,
                                           u_woff, static_cast<T*>(y), N, K, groups);
  return cudaGetLastError();
}

// The cells packed for the kernel above (window_wgmma_pack in
// kernels/bsmm.py; replaces no TPU kernel: the TPU kernel reads the blocks
// where they lie): cell c is A = (64 features) x (KD inputs), K-major in
// KD * 2-byte rows, element (m, k) = W[id][k'][m'] in fprop, W[id][m'][k']
// in bprop (trans_w), for the block id = cell_w[c][jm * SUBK + jk] the
// cell spans at (m, k) (zeros where -1): at b < 64 jm = m / B, m' = m % B,
// jk = k / B, k' = k % B; at b64 and b128 one block, m' = mo + m, k' = ko +
// k with cell_w[c][1] = mo << 16 | ko.  16-byte chunk j of row m at chunk
// j ^ ((m * KD * 2 >> 7) & (KD / 8 - 1)), as wgmma's swizzle of KD * 2-byte
// rows reads it.  One thread a 16-byte chunk; bound by bytes.
template <int B>
__global__ void bsmm_window_wgmma_pack_kernel(const uint16_t* __restrict__ w,
                                              const int* __restrict__ cell_w,
                                              uint4* __restrict__ wp, long long chunks,
                                              int trans_w) {
  constexpr int KD = B < 16 ? 16 : (B > 64 ? 64 : B);
  constexpr int RCH = KD / 8, CELL = 64 * RCH;         // 16-byte chunks a row, a cell
  constexpr int SUBM = B < 64 ? 64 / B : 1, SUBK = B < KD ? KD / B : 1;
  constexpr int CW = SUBM * SUBK + 1;                  // cell_w's entries a cell
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < chunks;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long c = i / CELL;
    const int rc = static_cast<int>(i % CELL), m = rc / RCH;
    const int k0 = ((rc % RCH) ^ (((m * KD * 2) >> 7) & (RCH - 1))) * 8;
    const int* cw = cell_w + c * CW;
    int id, mi, ki;
    if constexpr (B < 64) {
      id = __ldg(cw + (m / B) * SUBK + k0 / B);
      mi = m % B;
      ki = k0 % B;
    } else {
      const int off = __ldg(cw + 1);
      id = __ldg(cw);
      mi = (off >> 16) + m;
      ki = (off & 0xffff) + k0;
    }
    uint4 v = make_uint4(0, 0, 0, 0);
    if (id >= 0) {
      const uint16_t* blk = w + static_cast<size_t>(id) * B * B;
      if (trans_w) {
        v = *reinterpret_cast<const uint4*>(blk + mi * B + ki);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) e[t] = __ldg(blk + (ki + t) * B + mi);
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    wp[i] = v;
  }
}

// registers, local (spilled) bytes, dynamic shared memory, resident thread
// blocks an SM and ring slots of one instantiation
template <typename T, int KD>
cudaError_t info_of(int* info) {
  auto kernel = bsmm_window_wgmma_kernel<T, KD>;
  constexpr size_t bytes = smem_bytes<KD>();
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
  info[4] = Cfg<KD>::STAGES;
  return cudaSuccess;
}

#define WIN_ARGS x, wp, u_ptr, u_in, u_mask, u_woff, y, N, C, K, groups, s

template <typename T>
cudaError_t dispatch(int bsize, const void* x, const void* wp, const int* u_ptr,
                     const int* u_in, const int* u_mask, const int* u_woff, void* y, int N,
                     int C, int K, int groups, cudaStream_t s) {
  switch (bsize) {
    case 8:
    case 16: return launch<T, 16>(WIN_ARGS);
    case 32: return launch<T, 32>(WIN_ARGS);
    case 64:
    case 128: return launch<T, 64>(WIN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t info_dispatch(int bsize, int* info) {
  switch (bsize) {
    case 8:
    case 16: return info_of<T, 16>(info);
    case 32: return info_of<T, 32>(info);
    case 64:
    case 128: return info_of<T, 64>(info);
    default: return cudaErrorInvalidValue;
  }
}

template <int B>
cudaError_t pack(int trans_w, const void* w, const int* cell_w, void* wp, long long cells,
                 cudaStream_t s) {
  constexpr int KD = B < 16 ? 16 : (B > 64 ? 64 : B);
  const long long chunks = cells * 64 * KD / 8;
  if (chunks < 1) return cudaSuccess;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long want = (chunks + 255) / 256, cap = 8LL * sms;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  bsmm_window_wgmma_pack_kernel<B><<<grid, 256, 0, s>>>(static_cast<const uint16_t*>(w), cell_w,
                                                        static_cast<uint4*>(wp), chunks, trans_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; bsize 8-128; any other returns
// cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w is read by the
// packing alone (wp holds the cells of either direction).  u_ptr (groups +
// 1), u_in, u_mask and u_woff (items): window_wgmma_plan's arrays over the
// CSR of y's block-columns; wp: window_wgmma_pack's cells.  x, wp and y
// 16-byte aligned, C and K multiples of 8, N >= 1.  Returns a cudaError_t
// (0 = launched).
extern "C" int bsmm_window_wgmma_nc(int dtype, int bsize, int trans_w, const void* x,
                                    const void* wp, const int* u_ptr, const int* u_in,
                                    const int* u_mask, const int* u_woff, void* y, int N, int C,
                                    int K, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)trans_w;
  if (N < 1 || groups < 1) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, WIN_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, WIN_ARGS);
  return cudaErrorInvalidValue;
}

// w (blocks, bsize, bsize) of a 16-bit type, 16-byte aligned; cell_w
// (cells, SUBM * SUBK + 1) int32 (window_wgmma_plan's); wp (cells, 64 *
// KD).  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_window_wgmma_pack_nc(int bsize, int trans_w, const void* w,
                                         const int* cell_w, void* wp, long long cells,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bsize) {
    case 8: return pack<8>(trans_w, w, cell_w, wp, cells, s);
    case 16: return pack<16>(trans_w, w, cell_w, wp, cells, s);
    case 32: return pack<32>(trans_w, w, cell_w, wp, cells, s);
    case 64: return pack<64>(trans_w, w, cell_w, wp, cells, s);
    case 128: return pack<128>(trans_w, w, cell_w, wp, cells, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype 1 (bf16) or 2 (f16), bsize 8-128: info[0..4] = registers, local
// bytes, dynamic shared memory, resident thread blocks an SM, ring slots.
extern "C" int bsmm_window_wgmma_info(int dtype, int bsize, int* info) {
  if (dtype == 1) return info_dispatch<__nv_bfloat16>(bsize, info);
  if (dtype == 2) return info_dispatch<__half>(bsize, info);
  return cudaErrorInvalidValue;
}

#undef WIN_ARGS
