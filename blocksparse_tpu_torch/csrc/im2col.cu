// im2col for the block-sparse conv (impl="bsmm"):
//   im2col  image x -> X (C*R*S, N*H*W), X row (cb*trs + t)*bC + ci,
//           tap t = r*S + s, X[row, (n, h, w)] = x[n, c, h + r - pt, w + s - pl]
//           (c = cb*bC + ci) and 0 where that pixel lies outside the image.
// x is read in place: element (n, c, h, w) at n*sn + c*sc + h*W + w, so an
// NCHW image (sc = H*W, sn = C*H*W) and a channel-major (C, N*H*W) array
// (sc = N*H*W, sn = H*W) go in alike, with no transposing copy.
// X is stored in the NC orientation the block-sparse matmul kernels read:
// element (row, p) at p * C*R*S + row.  So X reaches bsmm_fprop and
// bsmm_updat with no transposing copy.  Its adjoint, col2im, is
// col2im_tma.cu.
//
// Replaces the TPU kernel im2col / _im2col_fwd_impl
// (blocksparse_tpu/kernels/im2col.py).  On the TPU each grid step loads a
// channel-block tile and emits every tap as a lane roll plus a boundary mask.
//
// Bound on the H100: bytes.  It reads the image once and writes X once, (trs
// + 1) * C * N*H*W elements: at the conv bench's C=512 (N 32, 32x32, 3x3,
// b32, bf16) 34 MB + 302 MB, 0.100 ms at 3.35 TB/s; 0.200 ms at C=1024 and
// 0.401 ms at C=2048.  X is nine tenths of the bytes: the kernel is a
// stream of 16-byte stores.
//
// Design.  A copy moves bits: the kernel works on 16- or 32-bit words (bf16
// and f16 are one instantiation), so it is bit-exact in every dtype.  A
// thread block owns a tile of TH x TW output pixels of one image and CB
// channels (CB = bC, or a divisor of it where a tile would not fit).
// 1. It loads the tile's halo, CB channels x (TH + R - 1) rows x WS columns
//    (WS = LP + TW + RP, the halo's LP = pl and RP = S - 1 - pl columns
//    rounded up to whole 16-byte runs), once, into shared memory in the
//    input's type, channel-minor: [row][column][channel].  Each thread takes
//    VEC channels x one 16-byte run of VEC pixels (VEC 16-byte loads along
//    the image rows), transposes the VEC x VEC words in registers
//    (__byte_perm for 16-bit words) and stores VEC 16-byte vectors, each one
//    pixel's VEC channels.  Rows and runs outside the image are zeros: the
//    padding.  Where W, the strides or the start are off 16 bytes, one word
//    a thread instead (the same tile, slower).
// 2. Each pixel's run of X for the tile's channels, trs taps x CB channels,
//    is then a sequence of 16-byte chunks, and a chunk of tap (r, s) is one
//    16-byte read of shared memory at pixel (py + r, px + s).  A thread owns
//    ITEMS (pixel, chunk) items, the same in every tap, with their
//    shared-memory and X offsets computed once; for each tap it copies them
//    with one 16-byte load and one 16-byte store each.  A warp's store
//    covers 32 / (CB/VEC) pixels' runs of CB channels: whole 32-byte
//    sectors from CB*elem = 32 bytes up.  Lanes read consecutive 16-byte
//    slots of shared memory (a tap's chunks of neighbouring pixels are
//    neighbours there), free of bank conflicts within a tile row.
// So each input pixel is read from device memory once (plus the halo rows
// of neighbouring tiles, mostly from L2) and X is written in whole 16-byte
// runs.  Tile shape: im2col_tile in kernels/im2col.py (shapes only): TW
// covers W in 16-byte runs, TH the rows ITEMS x 256 threads' chunks leave,
// the halo within 64 KB (three blocks an SM), CB halved only where even one
// row would not fit a block's 227 KB.
//
// Prediction (written before the first timed run; NVIDIA H100 80GB HBM3,
// 3x3, b32, bf16, N 32, 32x32): 0.13-0.16 ms at C=512 (bound 0.100, 63-77%
// of it; the previous kernel 0.237), 0.26-0.32 ms at C=1024 (bound 0.200)
// and 0.52-0.64 ms at C=2048 (bound 0.401): 2.1-2.6 TB/s, a stream of
// stores of 64-byte segments.
//
// Scope (the TPU kernel's, im2col_supported): 2-D, stride 1, dilation 1,
// output dims = input dims, 0 <= pt < R, 0 <= pl < S, bC in {8, 16, 32, 64,
// 128} dividing C, any N*H*W.  Element offsets are 64-bit: C*trs*N*H*W
// passes 2^31 at real sizes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;            // (pixel, 16-byte chunk) items a thread copies a tap
constexpr int MAX_SMEM = 232448;    // the most shared memory a block may take

template <int E> struct Word;
template <> struct Word<2> { using U = uint16_t; };
template <> struct Word<4> { using U = uint32_t; };

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// in[k]: channel k's VEC consecutive pixels; out[j]: pixel j's VEC channels.
// 32-bit words: a 4 x 4 transpose.
__device__ __forceinline__ void transpose(const uint4 (&in)[4], uint4 (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = make_uint4(word(in[0], j), word(in[1], j), word(in[2], j), word(in[3], j));
}
// 16-bit words: word i of in[k] holds pixels 2i (low half) and 2i + 1 (high
// half) of channel k; word m of out[j] channels 2m and 2m + 1 of pixel j.
__device__ __forceinline__ void transpose(const uint4 (&in)[8], uint4 (&out)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = j / 2;
    const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;  // high halves : low halves
    out[j] = make_uint4(__byte_perm(word(in[0], i), word(in[1], i), sel),
                        __byte_perm(word(in[2], i), word(in[3], i), sel),
                        __byte_perm(word(in[4], i), word(in[5], i), sel),
                        __byte_perm(word(in[6], i), word(in[7], i), sel));
  }
}

// shared memory: the halo tile, then the taps' offsets into it
size_t smem_bytes(int E, int CB, int rows, int WS, int trs) {
  return (size_t)rows * WS * CB * E + (size_t)trs * sizeof(int);
}

template <int E, int CB>
__global__ void __launch_bounds__(THREADS)
im2col_kernel(const void* __restrict__ xv, void* __restrict__ Xv, long long sn, long long sc,
              int H, int W, int R, int S, int pt, int pl, int bC, long long CT, int TH, int TW,
              int LP, int WS, int ncs, int ntw, int nth, int vec) {
  using U = typename Word<E>::U;
  constexpr int VEC = 16 / E;       // words of a 16-byte vector
  constexpr int G = CB / VEC;       // 16-byte chunks of a pixel's CB channels
  const U* x = static_cast<const U*>(xv);
  U* X = static_cast<U*>(Xv);
  extern __shared__ uint4 smem[];
  U* tile = reinterpret_cast<U*>(smem);
  const int rows = TH + R - 1, trs = R * S;
  int* taps = reinterpret_cast<int*>(tile + (size_t)rows * WS * CB);
  const int tid = threadIdx.x;

  // tile -> (channel slice, column tile, row tile, image), slices fastest:
  // the blocks at work at once write neighbouring runs of the same rows of X
  int rest = blockIdx.x;
  const int cs = rest % ncs;
  rest /= ncs;
  const int tw = rest % ntw;
  rest /= ntw;
  const int th = rest % nth, n = rest / nth;
  const int c0 = cs * CB, h0 = th * TH, w0 = tw * TW;
  const int hl = h0 - pt, wl = w0 - LP;   // the input pixel of shared row 0, column 0
  const U* xb = x + n * sn + c0 * sc;

  for (int t = tid; t < trs; t += THREADS) taps[t] = ((t / S) * WS + t % S) * CB;

  // 1. the halo tile, [row][column][channel]
  if (vec) {
    const int groups = WS / VEC;
    const int items = rows * groups * G;
    for (int it = tid; it < items; it += THREADS) {
      const int cg = it % G, rg = it / G;
      const int g = rg % groups, hh = rg / groups;
      const int h = hl + hh, w = wl + g * VEC;
      uint4 in[VEC], out[VEC];
      if (h >= 0 && h < H && w >= 0 && w < W) {  // a whole run: W % VEC == 0
        const U* src = xb + (long long)(cg * VEC) * sc + (long long)h * W + w;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          in[k] = __ldg(reinterpret_cast<const uint4*>(src + k * sc));
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) in[k] = make_uint4(0u, 0u, 0u, 0u);
      }
      transpose(in, out);
      U* dst = tile + ((size_t)(hh * WS + g * VEC) * CB + cg * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) *reinterpret_cast<uint4*>(dst + j * CB) = out[j];
    }
  } else {
    const int items = rows * WS * CB;
    for (int it = tid; it < items; it += THREADS) {
      const int col = it % WS, rc = it / WS;
      const int ci = rc % CB, hh = rc / CB;
      const int h = hl + hh, w = wl + col;
      U v = 0;
      if (h >= 0 && h < H && w >= 0 && w < W) v = xb[(long long)ci * sc + (long long)h * W + w];
      tile[(size_t)(hh * WS + col) * CB + ci] = v;
    }
  }
  __syncthreads();

  // 2. X: item i of this thread is chunk cg of pixel (py, px); its tap t is
  // the 16 bytes at tile[soff + taps[t]], stored at X[xoff + t*bC]
  const int cb = c0 / bC, ci0 = c0 % bC;
  int soff[ITEMS];
  long long xoff[ITEMS];
  bool live[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = tid + i * THREADS;
    const int pix = it / G, cg = it % G;
    const int py = pix / TW, px = pix % TW;
    const int h = h0 + py, w = w0 + px;
    live[i] = py < TH && h < H && w < W;
    soff[i] = (py * WS + LP - pl + px) * CB + cg * VEC;
    xoff[i] = ((long long)n * H * W + (long long)h * W + w) * CT + (long long)cb * trs * bC +
              ci0 + cg * VEC;
  }
  for (int t = 0; t < trs; ++t) {
    const int toff = taps[t];
    const long long tx = (long long)t * bC;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (live[i])
        *reinterpret_cast<uint4*>(X + xoff[i] + tx) =
            *reinterpret_cast<const uint4*>(tile + soff[i] + toff);
  }
}

template <int E, int CB>
cudaError_t launch(const void* x, void* X, int C, int N, int H, int W, int R, int S, int pt,
                   int pl, int bC, long long sc, long long sn, int TH, int TW,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / E, G = CB / VEC;
  if (bC % CB || TH < 1 || TW < VEC || TW % VEC ||
      (long long)TH * TW * G > (long long)ITEMS * THREADS)
    return cudaErrorInvalidValue;
  const int LP = (pl + VEC - 1) / VEC * VEC, RP = (S - 1 - pl + VEC - 1) / VEC * VEC;
  const int WS = LP + TW + RP, rows = TH + R - 1, trs = R * S;
  const size_t bytes = smem_bytes(E, CB, rows, WS, trs);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = im2col_kernel<E, CB>;
  static unsigned ready = 0;  // the opt-in, once per device, at the most a block takes
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 32) ready |= 1u << dev;
  }
  const int ncs = C / CB, ntw = (W + TW - 1) / TW, nth = (H + TH - 1) / TH;
  const long long blocks = (long long)ncs * ntw * nth * N;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = W % VEC == 0 && sc % VEC == 0 && sn % VEC == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<(unsigned)blocks, THREADS, bytes, stream>>>(x, X, sn, sc, H, W, R, S, pt, pl, bC,
                                                      (long long)C * trs, TH, TW, LP, WS, ncs,
                                                      ntw, nth, vec);
  return cudaGetLastError();
}

#define IM2COL_ARGS x, X, C, N, H, W, R, S, pt, pl, bC, sc, sn, TH, TW, s

template <int E>
cudaError_t dispatch(int CB, const void* x, void* X, int C, int N, int H, int W, int R, int S,
                     int pt, int pl, int bC, long long sc, long long sn, int TH, int TW,
                     cudaStream_t s) {
  switch (CB) {
    case 8: return launch<E, 8>(IM2COL_ARGS);
    case 16: return launch<E, 16>(IM2COL_ARGS);
    case 32: return launch<E, 32>(IM2COL_ARGS);
    case 64: return launch<E, 64>(IM2COL_ARGS);
    case 128: return launch<E, 128>(IM2COL_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x: the image, element
// (n, c, h, w) at n*sn + c*sc + h*W + w (elements); X out, (C*R*S, N*H*W)
// stored NC: a contiguous (N*H*W, C*R*S) array, 16-byte aligned.  CB
// channels and TH x TW output pixels a tile, as im2col_tile
// (kernels/im2col.py) picks them.  Returns a cudaError_t (0 = launched).
extern "C" int im2col_fwd(int dtype, const void* x, void* X, int C, int N, int H, int W, int R,
                          int S, int pt, int pl, int bC, long long sc, long long sn, int CB,
                          int TH, int TW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || N <= 0 || H <= 0 || W <= 0 || bC <= 0 || C % bC || pt < 0 || pt >= R ||
      pl < 0 || pl >= S || (long long)N * H * W > 0x7fffffffLL || sc < 0 || sn < 0 ||
      reinterpret_cast<uintptr_t>(X) % 16)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<4>(CB, IM2COL_ARGS);
  if (dtype == 1 || dtype == 2) return dispatch<2>(CB, IM2COL_ARGS);
  return cudaErrorInvalidValue;
}

#undef IM2COL_ARGS
