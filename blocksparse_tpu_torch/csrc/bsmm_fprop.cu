// Block-sparse matmul xprop in the NC orientation (feature_axis=1), f32:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (TRANS).
//
// Replaces, for f32 inputs, both directions of the TPU kernels
// xprop_pallas_dense_tile, xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py).  All three compute this product; the TPU
// picks among them for its MXU tiling.  bf16 and f16 run bsmm_xprop_mma.cu on
// the tensor cores.  f32 runs here in full fp32 on the CUDA cores (no TF32,
// no 3xTF32): the reference's f32 dots are exact.
//
// LUT: a CSR over output block-columns o.  Entries row_ptr[o]..row_ptr[o+1]
// hold (ent_in, ent_w): input block-column and weight block, sorted as
// BlocksparseMatMul sorts fprop_list (fprop: o = k, in = c) or bprop_list
// (bprop: o = c, in = k).  Split route: row_ptr is the CSR over the split
// plan's partial tiles (runs of one column's entries) and y the (N, tiles*B)
// array of their f32 sums, which bsmm_merge.cu adds in phase order.
//
// The sum order.  Each output is one fmaf chain, starting from 0: over its
// column's entries in LUT order, within an entry over the contraction index
// in ascending order.  Tiles, the ring and the grouping of columns below
// change which thread computes an output and when its operands arrive, never
// that chain, so every configuration gives the same bits, and so do
// bsmm_fine.cu and bsmm_window.cu, which keep the same chain.
//
// Bound on the H100: operations.  At the MoE LM's expert products (N 2,560,
// 512 <-> 2048 dense b32) a call is 5.4 GFLOP, 0.080 ms at the 67 TFLOP/s of
// f32 FMA, against ~13 MB of traffic (0.004 ms).  The design is an SGEMM on
// the CUDA cores that keeps the FMA pipes fed:
//
// - Column groups (the host plan xprop_groups in kernels/bsmm.py): output
//   columns whose entry lists name the same input blocks in the same order
//   share one thread block, GN = 128 / B of them side by side, so x is staged
//   once for all of them.  In a dense layout that is every column; in the
//   LSTM's gate layout (one layout tiled four times) the four gates of a
//   hidden block; elsewhere often one.  grp_col (groups, GN) names them, -1
//   past a group's last; with GN 1 it is the columns one a thread block,
//   longest entry list first.
// - An output tile of TM rows of N by BN = GN * B columns, each thread RM x
//   RN outputs: full groups at TM 64, 8 x 8 a thread (64 FMAs for 16 floats
//   read from shared memory); or one column at TM 32 (4 x 4 at b32, the
//   contraction staged 32 rows a stage).  The host rule xprop_tile picks
//   between the two from N and the plan's counts, so a small N or few
//   columns still fill the SMs.
// - A cp.async ring of STAGES stages of KC contraction rows: x's (TM, KC)
//   tile and the group's W tiles, so the next stages load while this one
//   computes; one barrier a stage.  Rows past N and empty slots are
//   zero-filled by the copy.
// - No transposes: x is staged as it lies (rows of N, contraction
//   contiguous) and read as float4 along the contraction, four steps at a
//   time.  fprop's W block lies (contraction, output) and is read as float4
//   along the outputs; bprop's lies (output, contraction), is staged as it
//   lies and read as float4 along the contraction.  Rows read along the
//   contraction are padded by four floats (an odd number of 16-byte units),
//   and the lanes of a warp form a 4 x 8 (or narrower) tile of threads, so a
//   warp's 16-byte reads fall in distinct banks or broadcast.
//
// Zeros are written for a column with no entries; no atomics.
#include "mma_sm90.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int GROUP_COLS = 128;  // columns of a full column group (GN * B)

// The tile of thread blocks owning GN block-columns of B at TM rows of N.
template <int B, int TM, int GN, bool TRANS> struct Cfg {
  static constexpr int BN = GN * B;
  static constexpr int RM = TM >= 64 ? 8 : 4;
  static constexpr int RN = BN >= 64 ? 8 : 4;
  // contraction rows a stage: 32 for a 4 x 4 thread tile, whose stage
  // would otherwise be short beside its copies and barrier
  static constexpr int KC = B < 16 ? B : RM * RN == 16 && B >= 32 ? 32 : 16;
  static constexpr int SPE = B / KC;          // stages an entry
  static constexpr int TRM = TM / RM, TCN = BN / RN;
  static constexpr int THREADS = TRM * TCN;
  // lanes of a warp: LI rows by LJ columns of threads
  static constexpr int LJ = TCN < 8 ? TCN : 8;
  static constexpr int LI = 32 / LJ < TRM ? 32 / LJ : TRM;
  static constexpr int XP = KC + 4;                  // a staged x row
  static constexpr int WP = TRANS ? KC + 4 : BN;     // a staged W row
  static constexpr int X_ELEMS = TM * XP;
  static constexpr int W_ELEMS = TRANS ? BN * WP : KC * BN;
  static constexpr int ELEMS = X_ELEMS + W_ELEMS;    // one ring stage
  static constexpr int XCH = TM * KC / 4, WCH = KC * BN / 4;  // 16-byte copies a stage
  static constexpr int NX = (XCH + THREADS - 1) / THREADS, NW = (WCH + THREADS - 1) / THREADS;
  // the ring, then the group's columns and their first entries
  static constexpr size_t SMEM = (size_t)STAGES * ELEMS * sizeof(float) + 2 * GN * sizeof(int);
  // an 8 x 8 tile keeps 64 accumulators: let it have the registers
  static constexpr int MIN_BLOCKS_ = (RM * RN == 64 ? (TRANS ? 384 : 256) : 512) / THREADS;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_ < 1 ? 1 : (MIN_BLOCKS_ > 16 ? 16 : MIN_BLOCKS_);
  static_assert(TRM % LI == 0 && TCN % LJ == 0, "lane tile");
  static_assert(THREADS >= GN, "a thread per slot reads the group");
};

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int B, int TM, int GN, bool TRANS>
__global__ void __launch_bounds__(Cfg<B, TM, GN, TRANS>::THREADS,
                                  Cfg<B, TM, GN, TRANS>::MIN_BLOCKS)
bsmm_xprop_nc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ row_ptr, const int* __restrict__ ent_in,
                     const int* __restrict__ ent_w, const int* __restrict__ grp_col,
                     float* __restrict__ y, int N, int C, int K) {
  using G = Cfg<B, TM, GN, TRANS>;
  constexpr int BN = G::BN, KC = G::KC, SPE = G::SPE, RM = G::RM, RN = G::RN;
  constexpr int TRM = G::TRM, TCN = G::TCN, THREADS = G::THREADS;
  constexpr int XP = G::XP, WP = G::WP, NX = G::NX, NW = G::NW;
  extern __shared__ __align__(16) float ring[];
  int* s_col = reinterpret_cast<int*>(ring + STAGES * G::ELEMS);
  int* s_base = s_col + GN;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TM;
  const int grp = blockIdx.y;
  const int o0 = grp_col[grp * GN];
  const int base0 = row_ptr[o0];
  const int steps = (row_ptr[o0 + 1] - base0) * SPE;
  if (tid < GN) {
    const int o = grp_col[grp * GN + tid];
    s_col[tid] = o;
    s_base[tid] = o >= 0 ? row_ptr[o] : -1;
  }
  __syncthreads();

  constexpr int LANES = G::LI * G::LJ, WJ = TCN / G::LJ;
  const int lane = tid % LANES, wid = tid / LANES;
  const int tr = (wid / WJ) * G::LI + lane / G::LJ;
  const int tc = (wid % WJ) * G::LJ + lane % G::LJ;

  // This thread's 16-byte copies of a stage, the same every stage: x's row
  // m and column k4 (none past N: zero-filled), W's slot, staged offset and
  // offset in its block at k0 = 0.
  int x_dst[NX], w_dst[NW], w_off[NW], w_base[NW];
  size_t x_src[NX];
  bool x_ok[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int ch = tid + i * THREADS;
    const int m = ch / (KC / 4), k4 = ch % (KC / 4);
    x_ok[i] = (G::XCH % THREADS == 0 || ch < G::XCH) && n0 + m < N;
    x_dst[i] = m * XP + k4 * 4;
    x_src[i] = (size_t)(n0 + m) * C + k4 * 4;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int ch = tid + i * THREADS;
    int slot;
    if constexpr (TRANS) {  // row r of the staged (BN, KC) tile: W[w][j][k0 ..]
      const int r = ch / (KC / 4), k4 = ch % (KC / 4);
      slot = r / B;
      w_dst[i] = r * WP + k4 * 4;
      w_off[i] = (r % B) * B + k4 * 4;
    } else {                // row k of the staged (KC, BN) tile: W[w][k0 + k][..]
      const int k = ch / (BN / 4), j = ch % (BN / 4) * 4;
      slot = j / B;
      w_dst[i] = k * WP + j;
      w_off[i] = k * B + j % B;
    }
    // -1: no copy (past the stage's chunks), -2: an empty slot (zeros)
    const bool live = G::WCH % THREADS == 0 || ch < G::WCH;
    w_base[i] = !live ? -1 : s_base[slot] >= 0 ? s_base[slot] : -2;
  }

  // The LUT values of the next stage to load, read a stage ahead so that
  // their latency hides behind the FMAs.
  int nx_in = 0, nx_w[NW];
  auto fetch = [&](int step) {
    const int e = step / SPE;
    nx_in = ent_in[base0 + e];
#pragma unroll
    for (int i = 0; i < NW; ++i) nx_w[i] = w_base[i] >= 0 ? ent_w[w_base[i] + e] : 0;
  };

  // Stage `step` (entry step / SPE, its contraction rows (step % SPE) * KC
  // .. + KC) into ring slot `slot`, from the values fetch(step) read.
  auto load = [&](int step, int slot) {
    float* xs = ring + slot * G::ELEMS;
    float* ws = xs + G::X_ELEMS;
    const int k0 = (step % SPE) * KC;
    const float* xb = x + (size_t)nx_in * B + k0;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (G::XCH % THREADS == 0 || tid + i * THREADS < G::XCH)
        cp_async16(smem_addr(xs + x_dst[i]), x_ok[i] ? xb + x_src[i] : x, x_ok[i]);
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (w_base[i] != -1) {
        const bool v = w_base[i] >= 0;
        const float* src = w + (size_t)nx_w[i] * B * B + w_off[i] + (TRANS ? k0 : k0 * B);
        cp_async16(smem_addr(ws + w_dst[i]), v ? src : w, v);
      }
  };

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[r][j] = 0.f;

  // One stage: KC contraction rows, four at a time, each output's fmaf in
  // ascending contraction order.
  auto compute = [&](int slot) {
    const float* xs = ring + slot * G::ELEMS;
    const float* ws = xs + G::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 xv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + (tr + r * TRM) * XP + kk);
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float4 t = *reinterpret_cast<const float4*>(ws + (tc + j * TCN) * WP + kk);
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            acc[r][j] = fmaf(xv[r].x, t.x, acc[r][j]);
            acc[r][j] = fmaf(xv[r].y, t.y, acc[r][j]);
            acc[r][j] = fmaf(xv[r].z, t.z, acc[r][j]);
            acc[r][j] = fmaf(xv[r].w, t.w, acc[r][j]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float b[RN];
#pragma unroll
          for (int q = 0; q < RN / 4; ++q) {
            const float4 t =
                *reinterpret_cast<const float4*>(ws + (kk + k) * WP + tc * 4 + q * TCN * 4);
            b[4 * q] = t.x;
            b[4 * q + 1] = t.y;
            b[4 * q + 2] = t.z;
            b[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float a = part(xv[r], k);
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[r][j] = fmaf(a, b[j], acc[r][j]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      fetch(s);
      load(s, s);
    }
    cp_async_commit();
  }
  if (STAGES - 1 < steps) fetch(STAGES - 1);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with slot (s - 1)
    const int next = s + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    cp_async_commit();
    if (next + 1 < steps) fetch(next + 1);
    compute(s % STAGES);
  }
  cp_async_wait<0>();

  // fprop: a thread's columns come four at a time (one float4 store);
  // bprop: one at a time, a warp's lanes on neighbouring columns
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int n = n0 + tr + r * TRM;
    if (n >= N) continue;
    float* yr = y + (size_t)n * K;
    if constexpr (TRANS) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tc + j * TCN, o = s_col[c / B];
        if (o >= 0) yr[o * B + c % B] = acc[r][j];
      }
    } else {
#pragma unroll
      for (int q = 0; q < RN / 4; ++q) {
        const int c = tc * 4 + q * TCN * 4, o = s_col[c / B];
        if (o >= 0)
          *reinterpret_cast<float4*>(yr + o * B + c % B) =
              make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
      }
    }
  }
}

struct Args {
  const float* x;
  const float* w;
  const int* row_ptr;
  const int* ent_in;
  const int* ent_w;
  const int* grp_col;
  float* y;
  int N, C, K, groups;
};

template <int B, int TM, int GN, bool TRANS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Cfg<B, TM, GN, TRANS>;
  auto kernel = bsmm_xprop_nc_kernel<B, TM, GN, TRANS>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, G::SMEM, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TM - 1) / TM, a.groups);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(a.x, a.w, a.row_ptr, a.ent_in, a.ent_w,
                                                a.grp_col, a.y, a.N, a.C, a.K);
  return cudaGetLastError();
}

// What a configuration's kernel takes on this card: threads, dynamic shared
// memory, registers, local (spilled) bytes a thread, resident blocks an SM.
template <int B, int TM, int GN, bool TRANS>
cudaError_t info(int* out) {
  using G = Cfg<B, TM, GN, TRANS>;
  auto kernel = bsmm_xprop_nc_kernel<B, TM, GN, TRANS>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, G::SMEM, ready);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, G::THREADS, G::SMEM);
  out[0] = G::THREADS;
  out[1] = static_cast<int>(G::SMEM + attr.sharedSizeBytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = resident;
  return err;
}

// Calls F<B, TM, GN, TRANS>::run(args...) for the configuration asked for,
// one of the two built: GN = GROUP_COLS / B columns a group at TM 64 (8 x 8
// a thread), or one column a group at TM 32.
template <template <int, int, int, bool> class F, int B, bool TRANS, typename... A>
cudaError_t by_tile(int gn, int tm, A... args) {
  constexpr int GMAX = GROUP_COLS / B;
  if (gn == GMAX && tm == 64) return F<B, 64, GMAX, TRANS>::run(args...);
  if (gn == 1 && tm == 32) return F<B, 32, 1, TRANS>::run(args...);
  return cudaErrorInvalidValue;
}

template <template <int, int, int, bool> class F, typename... A>
cudaError_t dispatch(int bsize, int trans, int gn, int tm, A... args) {
  switch (bsize) {
#define BSMM_CASE(B)                                                    \
  case B:                                                               \
    return trans ? by_tile<F, B, true>(gn, tm, args...)                 \
                 : by_tile<F, B, false>(gn, tm, args...);
    BSMM_CASE(8)
    BSMM_CASE(16)
    BSMM_CASE(32)
    BSMM_CASE(64)
    BSMM_CASE(128)
#undef BSMM_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int B, int TM, int GN, bool TRANS> struct Launch {
  static cudaError_t run(const Args& a, cudaStream_t s) { return launch<B, TM, GN, TRANS>(a, s); }
};
template <int B, int TM, int GN, bool TRANS> struct Info {
  static cudaError_t run(int* out) { return info<B, TM, GN, TRANS>(out); }
};

int xprop_nc(int dtype, int bsize, int trans_w, const void* x, const void* w,
             const int* row_ptr, const int* ent_in, const int* ent_w, const int* grp_col,
             void* y, int N, int C, int K, int groups, int gn, int tm, void* stream) {
  if (dtype != 0 || grp_col == nullptr) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w), row_ptr, ent_in,
               ent_w, grp_col, static_cast<float*>(y), N, C, K, groups};
  return dispatch<Launch>(bsize, trans_w, gn, tm, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32; any other returns cudaErrorInvalidValue (bf16 and f16
// run bsmm_xprop_mma.cu).  x is (N, C), y (N, K); trans_w = 0 for fprop
// (W[w] is (in, out)), 1 for bprop (W[w]^T).  grp_col: (groups, gn) int32
// column groups (xprop_launch); (gn, tm): (128 / bsize, 64) or (1, 32), the
// N-tile tm (xprop_tile picks).
// x and w 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_xprop_nc(int dtype, int bsize, int trans_w, const void* x, const void* w,
                             const int* row_ptr, const int* ent_in, const int* ent_w,
                             const int* grp_col, void* y, int N, int C, int K, int groups,
                             int gn, int tm, void* stream) {
  return xprop_nc(dtype, bsize, trans_w, x, w, row_ptr, ent_in, ent_w, grp_col, y, N, C, K,
                  groups, gn, tm, stream);
}

// The split route's partial tiles: the same kernel over the tile CSR
// (tile_ptr, its groups over tiles), y the f32 (N, tiles * bsize) array.
extern "C" int bsmm_xprop_nc_partials(int dtype, int bsize, int trans_w, const void* x,
                                      const void* w, const int* tile_ptr, const int* ent_in,
                                      const int* ent_w, const int* grp_col, void* y, int N,
                                      int C, int K, int groups, int gn, int tm, void* stream) {
  return xprop_nc(dtype, bsize, trans_w, x, w, tile_ptr, ent_in, ent_w, grp_col, y, N, C, K,
                  groups, gn, tm, stream);
}

// out[5]: threads, shared memory bytes a block, registers a thread, local
// (spilled) bytes a thread, blocks an SM holds, of the configuration (bsize,
// trans_w, gn, tm).  Returns a cudaError_t.
extern "C" int bsmm_xprop_nc_info(int bsize, int trans_w, int gn, int tm, int* out) {
  return dispatch<Info>(bsize, trans_w, gn, tm, out);
}
