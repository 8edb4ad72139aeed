// Block-sparse matmul xprop on Hopper's tensor cores, bf16 and f16, in the NC
// orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w);
//   the split route's unrounded f32 partial tiles (OUT_PARTIAL);
//   and the split route in one launch (OUT_SPLIT): its runs' partial tiles
//   summed across a thread-block cluster and rounded once.
//
// Replaces, for bf16 and f16 inputs, the TPU kernels xprop_pallas_dense_tile,
// xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py).  On the unsplit route the rule
// (xprop_kernel in kernels/bsmm.py) keeps it for b8 and b16, for products
// whose tiles fill under half the card, and for b128 groups whose staged x
// tile serves under 3 columns; b32 goes to bsmm_xprop_sparse.cu, b64 and
// the other b128 products to bsmm_xprop_wgmma.cu.  f32 inputs stay on
// bsmm_fprop.cu, in full fp32 on the CUDA cores: the reference's f32 dots are
// Precision.HIGHEST, and the tensor cores would round them to TF32.  The C
// interface is bsmm_fprop.cu's: the same CSR LUT (row_ptr, ent_in, ent_w) in
// the same order, the same trans_w flag, the same partial tiles for
// bsmm_merge.cu; an empty output column writes zeros.
//
// One thread block owns one (N-tile of TM rows, output block-column o);
// the blocks of one N-tile are launched together (o runs fastest), so an x
// tile that device memory delivers once serves every column that reads it
// from L2, even where x is far larger than L2 (the conv's 302 MB X).
//
// Mapping onto mma.sync.m16n8k16 with f32 accumulators in registers:
//   M = the N-tile's TM token rows (XPROP_TM in kernels/bsmm.py);
//   N = the B output columns of block-column o (B / 8 n8 tiles);
//   K = the contraction, with o's LUT entries concatenated along it:
//       sum_e x[:, in_e*B : +B] . W[w_e] is one product of depth L*B.
// A stage of the ring holds KC = max(B, 64) contraction rows (KC / B entries:
// b8 pairs two entries in one k16 step, an odd last one padded by zeros) of
// the x tile (TM x KC, row-major, read by ldmatrix) and of the weights: in
// fprop W[w] as stored, (in, out) = (k, n), read by ldmatrix.trans; in bprop
// W[w] as stored is (n, k), which plain ldmatrix reads (no transposing
// stores).  cp.async copies 16 bytes a thread into STAGES ring slots, so the
// next stages are in flight while the warps run the mma of this one; one
// barrier a stage.  x rows past N and entry slots past the column's end are
// zero-filled by the copy (src-size 0).  Rows are padded by 16 bytes so the
// eight row addresses of an ldmatrix fall in distinct banks.  Four warps
// split the TM x B tile WM x WN; a warp whose rows all lie past N skips its
// mma.  The epilogue stages the tile in shared memory and writes y with
// 16-byte stores, rounded once (bf16 / f16) or unrounded f32 (OUT_PARTIAL).
//
// The split route fused (OUT_SPLIT; replaces, for bf16 and f16, the TPU
// kernel merge_phased_tiles, which bsmm_merge.cu ports as a second launch
// over f32 tiles in device memory).  Where the unsplit grid leaves SMs
// idle, each output column's entries are cut into P <= 8 runs (split_plan
// in kernels/bsmm.py).  Here the P thread blocks of one (N-tile, column o)
// form a cluster of P (cudaLaunchKernelEx, cluster dimension {P, 1, 1}):
// rank r runs the mainloop above over run merge_idx[o, r] (the sentinel's
// empty run past the column's last, whose tile is zeros) and stages its
// unrounded f32 tile in its shared memory; after a cluster barrier, rank r
// sums its 1/P share of the tile's rows below N over the P tiles, read
// through distributed shared memory in rank order (acc = tile_0; acc +=
// tile_1; ...: bsmm_merge.cu's order, sentinel zeros included), rounds once
// and writes y with 16-byte stores; a second cluster barrier keeps each
// block's tile alive until its peers have read it.  The accumulators are
// the partial kernel's and the order is the merge's, so the result equals
// bsmm_merge(bsmm_partials(...)) bit for bit.  No f32 tiles in device
// memory, no atomics, no second launch.  The cluster's occupancy is
// checked once per P (cudaOccupancyMaxActiveClusters).
//
// Prediction for the fused split (written before its first timed run; NVIDIA
// H100 80GB HBM3, bf16):
// - Decode, N = 4, b32, d 0.5: bsmm1 (512 -> 2048, P 3) and bsmm2 (2048 ->
//   512, P 8) each take 4-7 us of device time a product, the parent's
//   partial kernel alone within 1 us of that, and its merge 1.5-2 us more:
//   device time a product falls by about the merge's 1.5-2 us.
// - Canonical hidden 2560 dense b32, N 64 (P 2): 8-15 us a product against
//   the parent's partials + merge at 1.5-2 us more (merge 0.0016 ms).
// - Launches: one fewer a product on the split route, 12 fewer a decode
//   step (two MLP products in each of six layers).
// - Decode tokens/s (host-bound, 10-12 ms of host enqueue a step): the
//   split route gains 1-3%, within the decode's run-to-run spread, and so
//   stays level with grouped (both one launch a product now).
//
// No atomics: each output's sum runs in a fixed order (stage by stage, k16
// step by k16 step), so two runs give identical bits.  The order is not
// bsmm_fprop.cu's fmaf chain, so in bf16 and f16 the fine and window kernels
// agree with this one within the dtype's rounding, not bit for bit (in f32,
// which never comes here, they do).
//
// Bound on the H100: at the LM's training shape (N = 16384, b32, 558 blocks,
// 512 -> 2048) a call is 18.7 GFLOP (0.019 ms of bf16 tensor-core work)
// against 85 MB of inputs and outputs (0.0254 ms): bound by bytes.  This
// design re-reads the x tile once per output block-column (from L2; x is
// 16 MB there), N * blocks * B * 2 bytes in all, which is what it spends
// beyond the bound; W is read once per N-tile.  At decode (N = 4) the bytes
// of W bound it; they are read once per call.
#include <cooperative_groups.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS, STAGES = 3;

// Output tile per thread block: TM rows of N by the B columns of one
// block-column, split over WM x WN warps.
template <int B> struct Tile;
template <> struct Tile<8>   { static constexpr int TM = 64,  WM = 4, WN = 1; };
template <> struct Tile<16>  { static constexpr int TM = 128, WM = 4, WN = 1; };
template <> struct Tile<32>  { static constexpr int TM = 128, WM = 4, WN = 1; };
template <> struct Tile<64>  { static constexpr int TM = 128, WM = 4, WN = 1; };
template <> struct Tile<128> { static constexpr int TM = 64,  WM = 2, WN = 2; };

// One ring slot, in elements: the x tile (TM rows of KC, padded), then the
// weights: fprop KC rows (k) of B (b8's 16-byte rows are conflict-free
// unpadded), bprop B rows (n) of KC.
template <int B, bool TRANS> struct Slot {
  static constexpr int TM = Tile<B>::TM;
  static constexpr int KC = B < 64 ? 64 : B;
  static constexpr int EPS = KC / B;           // entries a stage
  static constexpr int XLD = KC + 8;
  static constexpr int WLD = TRANS ? KC + 8 : (B == 8 ? B : B + 8);
  static constexpr int WROWS = TRANS ? B : KC;
  static constexpr int X_ELEMS = TM * XLD;
  static constexpr int ELEMS = X_ELEMS + WROWS * WLD;
};

// What the epilogue writes (a template flag, like TRANS): y rounded once
// to T; the unrounded f32 partial tiles; or the split route fused, the
// cluster's partial tiles summed in rank order and rounded once to T.
constexpr int OUT_Y = 0, OUT_PARTIAL = 1, OUT_SPLIT = 2;

// the type the epilogue stages the tile in (f32 unless it is rounded
// straight away) and the type of y
template <typename T, int OUT> using Staged = std::conditional_t<OUT == OUT_Y, T, float>;
template <typename T, int OUT>
using Written = std::conditional_t<OUT == OUT_PARTIAL, float, T>;

template <typename T, int B, bool TRANS, int OUT>
constexpr size_t smem_bytes() {
  using TS = Staged<T, OUT>;
  using S = Slot<B, TRANS>;
  constexpr size_t ring = STAGES * S::ELEMS * sizeof(T);
  constexpr size_t out = S::TM * (B + 16 / sizeof(TS)) * sizeof(TS);
  return ring > out ? ring : out;
}

// eight f32 values rounded once to T (bf16 or f16), as one 16-byte store
template <typename T> __device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack2(v[2 * i], v[2 * i + 1], T());
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, int B, bool TRANS, int OUT, typename TO = Written<T, OUT>>
__global__ void __launch_bounds__(THREADS)
bsmm_xprop_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ row_ptr, const int* __restrict__ ent_in,
                      const int* __restrict__ ent_w, const int* __restrict__ merge_idx,
                      TO* __restrict__ y, int N, int C, int K, int P) {
  using S = Slot<B, TRANS>;
  constexpr int TM = S::TM, KC = S::KC, EPS = S::EPS, XLD = S::XLD, WLD = S::WLD;
  constexpr int WN = Tile<B>::WN;
  constexpr int MW = TM / Tile<B>::WM, NW = B / WN;  // a warp's rows and columns
  constexpr int MT = MW / 16, NT = NW / 8;           // its m16 and n8 tiles
  constexpr int BCH = B / 8;                         // 16-byte chunks of a block row
  constexpr int RCH = KC / 8;                        // 16-byte chunks of a stage row
  static_assert(THREADS % RCH == 0 && (TM * RCH) % THREADS == 0, "x staging");
  static_assert(NT == 1 || NT % 2 == 0, "n8 tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  // output block-columns run fastest: the blocks that read one x tile are
  // resident together, so it comes from device memory about once.  The
  // split route's cluster of P blocks shares one (N-tile, column o); its
  // rank r runs the column's r-th run, tile merge_idx[o, r] of row_ptr (a
  // rank past the column's runs gets the sentinel's empty run).
  const int n_out = K / B;
  int tile = blockIdx.x, rank = 0;
  if constexpr (OUT == OUT_SPLIT) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    tile = blockIdx.x / P;
  }
  const int o = tile % n_out;
  const int n0 = tile / n_out * TM;
  const int run = OUT == OUT_SPLIT ? merge_idx[o * P + rank] : o;
  const int e0 = row_ptr[run], e1 = row_ptr[run + 1];
  const int stages = (e1 - e0 + EPS - 1) / EPS;
  const bool live = n0 + wm * MW < N;

  // Stage s's x tile and weights into ring slot `slot`.
  auto load = [&](int s, int slot) {
    T* xs = ring + slot * S::ELEMS;
    T* ws = xs + S::X_ELEMS;
    {
      // every x chunk of this thread lies in one column of 16 bytes: one
      // entry, one LUT read
      const int kc = tid % RCH, t = kc / BCH;
      const int e = e0 + s * EPS + t;
      const bool ok = e < e1;
      const T* src = x + (ok ? (size_t)ent_in[e] * B : 0) + (kc % BCH) * 8;
#pragma unroll
      for (int i = 0; i < TM * RCH / THREADS; ++i) {
        const int m = tid / RCH + i * (THREADS / RCH);
        const bool v = ok && n0 + m < N;
        cp_async16(smem_addr(xs + m * XLD + kc * 8), v ? src + (size_t)(n0 + m) * C : x, v);
      }
    }
    constexpr int WCH = KC * B / 8;
#pragma unroll
    for (int i = 0; i < (WCH + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (WCH % THREADS == 0 || c < WCH) {
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
        const int e = e0 + s * EPS + t;
        const bool ok = e < e1;
        cp_async16(smem_addr(ws + dst_off), ok ? w + (size_t)ent_w[e] * B * B + src_off : w,
                   ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // The mma of one ring slot: KC / 16 k16 steps over the warp's tiles.
  auto compute = [&](int slot) {
    const T* xs = ring + slot * S::ELEMS;
    const T* ws = xs + S::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], smem_addr(xs + (wm * MW + mt * 16 + (lane & 15)) * XLD + kk +
                                 (lane >> 4) * 8));
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        // lanes 0-7 address k rows 0-7 (or n rows with k 0-7), lanes 8-15 k 8-15
        if constexpr (TRANS)
          ldsm_x2(b[0], smem_addr(ws + (wn * NW + (lane & 7)) * WLD + kk +
                                  ((lane >> 3) & 1) * 8));
        else
          ldsm_x2_t(b[0], smem_addr(ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * WLD +
                                    wn * NW));
      } else {
#pragma unroll
        for (int np = 0; np < NT; np += 2) {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          uint32_t r[4];
          const int n = wn * NW + np * 8 + (lane >> 4) * 8;
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
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt], T());
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
    if (live) compute(s % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the tile through shared memory, then 16-byte rows of y
  using TS = Staged<T, OUT>;
  constexpr int OLD = B + 16 / sizeof(TS);
  TS* os = reinterpret_cast<TS*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * MW + mt * 16 + g, c = wn * NW + nt * 8 + tg * 2;
      store2(os + r * OLD + c, acc[mt][nt][0], acc[mt][nt][1]);
      store2(os + (r + 8) * OLD + c, acc[mt][nt][2], acc[mt][nt][3]);
    }
  if constexpr (OUT == OUT_SPLIT) {
    // Every rank's f32 tile is staged; rank r sums its share of the rows
    // below N over the P tiles, read through distributed shared memory in
    // rank order (bsmm_merge.cu's order: acc = tile_0; acc += tile_1; ...),
    // rounds once and writes y.  The second cluster barrier keeps each
    // block's tile alive until its peers have read it.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int VEC = 8, OCH = B / VEC;  // 16 bytes of bf16 / f16
    const int rows = min(TM, N - n0), share = (rows + P - 1) / P;
    const int r0 = rank * share, r1 = min(rows, r0 + share);
    for (int c = tid; c < (r1 - r0) * OCH; c += THREADS) {
      const int r = r0 + c / OCH, q = c % OCH;
      float* mine = os + r * OLD + q * VEC;
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, 0) + i);
        v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
      }
      for (int p = 1; p < P; ++p) {
        const float* peer = cluster.map_shared_rank(mine, p);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 t = *reinterpret_cast<const float4*>(peer + i);
          v[i] += t.x, v[i + 1] += t.y, v[i + 2] += t.z, v[i + 3] += t.w;
        }
      }
      store8(y + (size_t)(n0 + r) * K + (size_t)o * B + q * VEC, v);
    }
    cluster.sync();
  } else {
    __syncthreads();
    constexpr int VEC = 16 / sizeof(TO), OCH = B / VEC;
    for (int c = tid; c < TM * OCH; c += THREADS) {
      const int r = c / OCH, q = c % OCH;
      if (n0 + r < N)
        *reinterpret_cast<uint4*>(y + (size_t)(n0 + r) * K + (size_t)o * B + q * VEC) =
            *reinterpret_cast<const uint4*>(os + r * OLD + q * VEC);
    }
  }
}

template <typename T, int B, bool TRANS, int OUT>
cudaError_t launch(const void* x, const void* w, const int* row_ptr, const int* ent_in,
                   const int* ent_w, const int* merge_idx, void* y, int N, int C, int K, int P,
                   cudaStream_t stream) {
  using TO = Written<T, OUT>;
  auto kernel = bsmm_xprop_mma_kernel<T, B, TRANS, OUT>;
  constexpr size_t bytes = smem_bytes<T, B, TRANS, OUT>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  constexpr int TM = Tile<B>::TM;
  const unsigned tiles = static_cast<unsigned>((N + TM - 1) / TM) * (K / B);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  TO* yt = static_cast<TO*>(y);
  if constexpr (OUT != OUT_SPLIT) {
    kernel<<<tiles, THREADS, bytes, stream>>>(xt, wt, row_ptr, ent_in, ent_w, merge_idx, yt, N,
                                              C, K, P);
    return cudaGetLastError();
  } else {
    // clusters of P thread blocks, one a (N-tile, output column)
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * P);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster that cannot be resident would never run: refuse it, once
    // per cluster size
    static unsigned fits = 0;
    if (!(fits >> P & 1u)) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      fits |= 1u << P;
    }
    err = cudaLaunchKernelEx(&cfg, kernel, xt, wt, row_ptr, ent_in, ent_w, merge_idx, yt, N, C,
                             K, P);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

#define XPROP_ARGS x, w, row_ptr, ent_in, ent_w, merge_idx, y, N, C, K, P, s

template <typename T, int OUT, int B>
cudaError_t launch_dir(int trans_w, const void* x, const void* w, const int* row_ptr,
                       const int* ent_in, const int* ent_w, const int* merge_idx, void* y, int N,
                       int C, int K, int P, cudaStream_t s) {
  return trans_w ? launch<T, B, true, OUT>(XPROP_ARGS) : launch<T, B, false, OUT>(XPROP_ARGS);
}

template <typename T, int OUT>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w, const int* row_ptr,
                     const int* ent_in, const int* ent_w, const int* merge_idx, void* y, int N,
                     int C, int K, int P, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch_dir<T, OUT, 8>(trans_w, XPROP_ARGS);
    case 16: return launch_dir<T, OUT, 16>(trans_w, XPROP_ARGS);
    case 32: return launch_dir<T, OUT, 32>(trans_w, XPROP_ARGS);
    case 64: return launch_dir<T, OUT, 64>(trans_w, XPROP_ARGS);
    case 128: return launch_dir<T, OUT, 128>(trans_w, XPROP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <int OUT>
int xprop_nc(int dtype, int bsize, int trans_w, const void* x, const void* w,
             const int* row_ptr, const int* ent_in, const int* ent_w, const int* merge_idx,
             void* y, int N, int C, int K, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16, OUT>(bsize, trans_w, XPROP_ARGS);
  if (dtype == 2) return dispatch<__half, OUT>(bsize, trans_w, XPROP_ARGS);
  return cudaErrorInvalidValue;
}

#undef XPROP_ARGS

}  // namespace

// bsmm_fprop.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any other
// dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0
// for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  x and w must be
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_xprop_mma_nc(int dtype, int bsize, int trans_w, const void* x,
                                 const void* w, const int* row_ptr, const int* ent_in,
                                 const int* ent_w, void* y, int N, int C, int K,
                                 void* stream) {
  return xprop_nc<OUT_Y>(dtype, bsize, trans_w, x, w, row_ptr, ent_in, ent_w, nullptr, y, N,
                         C, K, 1, stream);
}

// The split route's partial tiles: the same product over the tile CSR
// (tile_ptr), y an f32 (N, tiles * bsize) array.
extern "C" int bsmm_xprop_mma_nc_partials(int dtype, int bsize, int trans_w, const void* x,
                                          const void* w, const int* tile_ptr,
                                          const int* ent_in, const int* ent_w, void* y,
                                          int N, int C, int K, void* stream) {
  return xprop_nc<OUT_PARTIAL>(dtype, bsize, trans_w, x, w, tile_ptr, ent_in, ent_w, nullptr, y,
                               N, C, K, 1, stream);
}

// The split route in one launch: y (N, K) of the input dtype, K = n_out *
// bsize, column o the sum in rank order of the partial tiles of its runs
// merge_idx[o, 0 .. P-1] (n_out x P int32, ids into the tile CSR tile_ptr,
// the sentinel's empty run past a column's last), rounded once: bit for
// bit bsmm_merge_nc over bsmm_xprop_mma_nc_partials.  1 <= P <= 8 (a
// portable cluster); cudaErrorInvalidConfiguration if a cluster of P such
// blocks cannot be resident.
extern "C" int bsmm_xprop_mma_nc_split(int dtype, int bsize, int trans_w, const void* x,
                                       const void* w, const int* tile_ptr, const int* ent_in,
                                       const int* ent_w, const int* merge_idx, void* y, int N,
                                       int C, int K, int P, void* stream) {
  if (P < 1 || P > 8) return cudaErrorInvalidValue;
  return xprop_nc<OUT_SPLIT>(dtype, bsize, trans_w, x, w, tile_ptr, ent_in, ent_w, merge_idx,
                             y, N, C, K, P, stream);
}
