// Block-sparse matmul xprop on Hopper's tensor cores, bf16 and f16, in the NC
// orientation (feature_axis=1):
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (trans_w);
//   and the split route's unrounded f32 partial tiles (PARTIAL).
//
// Replaces, for bf16 and f16 inputs, the TPU kernels xprop_pallas_dense_tile,
// xprop_pallas_grouped(_panels) and xprop_pallas
// (blocksparse_tpu/kernels/bsmm.py).  f32 inputs stay on bsmm_fprop.cu, in
// full fp32 on the CUDA cores: the reference's f32 dots are
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
// 16-byte stores, rounded once (bf16 / f16) or unrounded f32 (PARTIAL).
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
#include <type_traits>

#include "mma_sm90.cuh"

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

template <typename T, int B, bool TRANS, bool PARTIAL>
constexpr size_t smem_bytes() {
  using TO = std::conditional_t<PARTIAL, float, T>;
  using S = Slot<B, TRANS>;
  constexpr size_t ring = STAGES * S::ELEMS * sizeof(T);
  constexpr size_t out = S::TM * (B + 16 / sizeof(TO)) * sizeof(TO);
  return ring > out ? ring : out;
}

template <typename T, int B, bool TRANS, bool PARTIAL,
          typename TO = std::conditional_t<PARTIAL, float, T>>
__global__ void __launch_bounds__(THREADS)
bsmm_xprop_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ row_ptr, const int* __restrict__ ent_in,
                      const int* __restrict__ ent_w, TO* __restrict__ y, int N, int C,
                      int K) {
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
  // resident together, so it comes from device memory about once
  const int n_out = K / B;
  const int o = blockIdx.x % n_out;
  const int n0 = blockIdx.x / n_out * TM;
  const int e0 = row_ptr[o], e1 = row_ptr[o + 1];
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
  constexpr int OLD = B + 16 / sizeof(TO);
  TO* os = reinterpret_cast<TO*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * MW + mt * 16 + g, c = wn * NW + nt * 8 + tg * 2;
      store2(os + r * OLD + c, acc[mt][nt][0], acc[mt][nt][1]);
      store2(os + (r + 8) * OLD + c, acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  constexpr int VEC = 16 / sizeof(TO), OCH = B / VEC;
  for (int c = tid; c < TM * OCH; c += THREADS) {
    const int r = c / OCH, q = c % OCH;
    if (n0 + r < N)
      *reinterpret_cast<uint4*>(y + (size_t)(n0 + r) * K + (size_t)o * B + q * VEC) =
          *reinterpret_cast<const uint4*>(os + r * OLD + q * VEC);
  }
}

template <typename T, int B, bool TRANS, bool PARTIAL>
cudaError_t launch(const void* x, const void* w, const int* row_ptr, const int* ent_in,
                   const int* ent_w, void* y, int N, int C, int K, cudaStream_t stream) {
  using TO = std::conditional_t<PARTIAL, float, T>;
  auto kernel = bsmm_xprop_mma_kernel<T, B, TRANS, PARTIAL>;
  constexpr size_t bytes = smem_bytes<T, B, TRANS, PARTIAL>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  constexpr int TM = Tile<B>::TM;
  const unsigned blocks = static_cast<unsigned>((N + TM - 1) / TM) * (K / B);
  kernel<<<blocks, THREADS, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           row_ptr, ent_in, ent_w, static_cast<TO*>(y), N, C,
                                           K);
  return cudaGetLastError();
}

#define XPROP_ARGS x, w, row_ptr, ent_in, ent_w, y, N, C, K, s

template <typename T, bool PARTIAL, int B>
cudaError_t launch_dir(int trans_w, const void* x, const void* w, const int* row_ptr,
                       const int* ent_in, const int* ent_w, void* y, int N, int C, int K,
                       cudaStream_t s) {
  return trans_w ? launch<T, B, true, PARTIAL>(XPROP_ARGS)
                 : launch<T, B, false, PARTIAL>(XPROP_ARGS);
}

template <typename T, bool PARTIAL>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w, const int* row_ptr,
                     const int* ent_in, const int* ent_w, void* y, int N, int C, int K,
                     cudaStream_t s) {
  switch (bsize) {
    case 8: return launch_dir<T, PARTIAL, 8>(trans_w, XPROP_ARGS);
    case 16: return launch_dir<T, PARTIAL, 16>(trans_w, XPROP_ARGS);
    case 32: return launch_dir<T, PARTIAL, 32>(trans_w, XPROP_ARGS);
    case 64: return launch_dir<T, PARTIAL, 64>(trans_w, XPROP_ARGS);
    case 128: return launch_dir<T, PARTIAL, 128>(trans_w, XPROP_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PARTIAL>
int xprop_nc(int dtype, int bsize, int trans_w, const void* x, const void* w,
             const int* row_ptr, const int* ent_in, const int* ent_w, void* y, int N, int C,
             int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16, PARTIAL>(bsize, trans_w, XPROP_ARGS);
  if (dtype == 2) return dispatch<__half, PARTIAL>(bsize, trans_w, XPROP_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

// bsmm_fprop.cu's interface for bf16 (dtype 1) and f16 (dtype 2); any other
// dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0
// for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  x and w must be
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_xprop_mma_nc(int dtype, int bsize, int trans_w, const void* x,
                                 const void* w, const int* row_ptr, const int* ent_in,
                                 const int* ent_w, void* y, int N, int C, int K,
                                 void* stream) {
  return xprop_nc<false>(dtype, bsize, trans_w, x, w, row_ptr, ent_in, ent_w, y, N, C, K,
                         stream);
}

// The split route's partial tiles: the same product over the tile CSR
// (tile_ptr), y an f32 (N, tiles * bsize) array.
extern "C" int bsmm_xprop_mma_nc_partials(int dtype, int bsize, int trans_w, const void* x,
                                          const void* w, const int* tile_ptr,
                                          const int* ent_in, const int* ent_w, void* y,
                                          int N, int C, int K, void* stream) {
  return xprop_nc<true>(dtype, bsize, trans_w, x, w, tile_ptr, ent_in, ent_w, y, N, C, K,
                        stream);
}
