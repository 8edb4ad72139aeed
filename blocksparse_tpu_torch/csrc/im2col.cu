// im2col for the block-sparse conv (impl="bsmm"):
//   im2col  xc (C, N*H*W) -> X (C*R*S, N*H*W), X row (cb*trs + t)*bC + ci,
//           tap t = r*S + s, X[row, (n, h, w)] = x[c, (n, h + r - pt, w + s - pl)]
//           and 0 where that pixel lies outside the image.
// X is stored in the NC orientation the block-sparse matmul kernels read:
// element (row, p) at p * C*R*S + row.  So X reaches bsmm_fprop and
// bsmm_updat with no transposing copy.  Its adjoint, col2im, is
// col2im_tma.cu.
//
// Replaces the TPU kernel im2col / _im2col_fwd_impl
// (blocksparse_tpu/kernels/im2col.py).  On the TPU each grid step loads a
// channel-block tile and emits every tap as a lane roll plus a boundary mask.
// Here one thread block owns one channel block cb and TP consecutive pixels p,
// and stages as many taps at once as 48 KB of shared memory holds (all nine
// of a 3x3 filter up to bC = 32).  It reads each tap's bC x TP shifted
// (masked) input tile along p, coalesced, and writes each pixel's taps x bC
// elements, one contiguous run of X (576 bytes for 3x3, b32, bf16).  A copy
// this thin is bound by its index math unless that is done once a pixel:
// each thread keeps one pixel on the pixel side, each warp one pixel at a
// time on the NC side, and the taps' offsets sit in a shared table.  Values
// pass through shared memory as f32, which holds every bf16 and f16 value
// exactly: im2col stays a bit-exact copy.
//
// Scope (the TPU kernel's, im2col_supported): 2-D, stride 1, dilation 1,
// output dims = input dims, 0 <= pt < R, 0 <= pl < S, bC in {8, 16, 32, 64,
// 128} dividing C, any N*H*W.  Element offsets are 64-bit: C*trs*N*H*W passes
// 2^31 at real sizes.
//
// Bound on the H100: a copy with index math, bound by bytes: (trs + 1) * C *
// N*H*W elements moved, each read or written once at least.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

constexpr int THREADS = 256;
constexpr int TP = 32;                // pixels a thread block owns
constexpr int SMEM_FLOATS = 12032;    // 47 KB: under the 48 KB a block takes unasked

// Taps a thread block stages at once: as many as fit in SMEM_FLOATS.
template <int BC> struct Group {
  static constexpr int im2col = SMEM_FLOATS / (BC * (TP + 1));
};

constexpr int WARPS = THREADS / 32;
constexpr int LANES = THREADS / TP;   // channels read at once on the pixel side

// The pixel offsets (dh, dw) of taps t0 .. t0 + g - 1 (tap t = r*S + s reads
// input pixel (h + r - pt, w + s - pl)), into shared memory.  Followed by a
// barrier.
__device__ __forceinline__ void tap_table(int* dh, int* dw, int t0, int g, int S, int pt,
                                          int pl) {
  for (int tt = threadIdx.x; tt < g; tt += THREADS) {
    dh[tt] = (t0 + tt) / S - pt;
    dw[tt] = (t0 + tt) % S - pl;
  }
  __syncthreads();
}

// The pixel side, (C, N*H*W) channel-major, is walked by threads with a fixed
// pixel p (coalesced along p); the NC side, (N*H*W, C*R*S), by warps that
// each take one pixel and walk its taps x bC run (coalesced along the run).
// The index math is done once per pixel, not per element.  smem: g x bC x
// (TP + 1) floats, g = min(trs, G) taps.
template <typename T, int BC>
__global__ void __launch_bounds__(THREADS)
im2col_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int NP, int H, int W,
              int R, int S, int pt, int pl) {
  extern __shared__ float tile[];       // [tap][ci][pixel]
  constexpr int G = Group<BC>::im2col;
  __shared__ int dh[G], dw[G];
  const int p0 = blockIdx.x * TP, cb = blockIdx.y;
  const int trs = R * S;
  const long long CT = (long long)C * trs;
  const int pp = threadIdx.x % TP, p = p0 + pp;
  const int pix = p % (H * W), h = pix / W, w = pix % W;
  const T* xb = x + (long long)cb * BC * NP + p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t0 = 0; t0 < trs; t0 += G) {
    const int g = trs - t0 < G ? trs - t0 : G;
    tap_table(dh, dw, t0, g, S, pt, pl);
    for (int tt = 0; tt < g; ++tt) {
      const int hh = h + dh[tt], ww = w + dw[tt];
      const bool in = p < NP && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int off = dh[tt] * W + dw[tt];
      for (int ci = threadIdx.x / TP; ci < BC; ci += LANES)
        tile[(tt * BC + ci) * (TP + 1) + pp] =
            in ? to_f32(xb[(long long)ci * NP + off]) : 0.f;
    }
    __syncthreads();
    // a pixel's g taps x bC channels are one contiguous run of X
    T* ob = out + (long long)(cb * trs + t0) * BC;
    for (int q = warp; q < TP && p0 + q < NP; q += WARPS)
      for (int tc = lane; tc < g * BC; tc += 32)
        ob[(long long)(p0 + q) * CT + tc] = from_f32<T>(tile[tc * (TP + 1) + q]);
    __syncthreads();
  }
}

template <typename T, int BC>
cudaError_t launch(const void* in, void* out, int C, int NP, int H, int W, int R, int S,
                   int pt, int pl, cudaStream_t stream) {
  const dim3 grid((NP + TP - 1) / TP, C / BC);
  const int trs = R * S;
  const int g = trs < Group<BC>::im2col ? trs : Group<BC>::im2col;
  im2col_kernel<T, BC><<<grid, THREADS, g * BC * (TP + 1) * sizeof(float), stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), C, NP, H, W, R, S, pt, pl);
  return cudaGetLastError();
}

#define IM2COL_ARGS in, out, C, NP, H, W, R, S, pt, pl, s

template <typename T>
cudaError_t dispatch(int bC, const void* in, void* out, int C, int NP, int H, int W, int R,
                     int S, int pt, int pl, cudaStream_t s) {
  switch (bC) {
    case 8: return launch<T, 8>(IM2COL_ARGS);
    case 16: return launch<T, 16>(IM2COL_ARGS);
    case 32: return launch<T, 32>(IM2COL_ARGS);
    case 64: return launch<T, 64>(IM2COL_ARGS);
    case 128: return launch<T, 128>(IM2COL_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

int run(int dtype, const void* in, void* out, int C, int N, int H, int W, int R, int S,
        int pt, int pl, int bC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NPL = (long long)N * H * W;
  if (C <= 0 || N <= 0 || H <= 0 || W <= 0 || bC <= 0 || C % bC || C / bC > 65535 ||
      NPL > 0x7fffffffLL - TP || pt < 0 || pt >= R || pl < 0 || pl >= S)
    return cudaErrorInvalidValue;
  const int NP = (int)NPL;
  if (dtype == 0) return dispatch<float>(bC, IM2COL_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bC, IM2COL_ARGS);
  if (dtype == 2) return dispatch<__half>(bC, IM2COL_ARGS);
  return cudaErrorInvalidValue;
}

#undef IM2COL_ARGS

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  xc (C, N*H*W) contiguous in;
// X out, (C*R*S, N*H*W) stored NC: a contiguous (N*H*W, C*R*S) array.
// Returns a cudaError_t (0 = launched).
extern "C" int im2col_fwd(int dtype, const void* xc, void* X, int C, int N, int H, int W,
                          int R, int S, int pt, int pl, int bC, void* stream) {
  return run(dtype, xc, X, C, N, H, W, R, S, pt, pl, bC, stream);
}
