// col2im, the adjoint of im2col, for the block-sparse conv (impl="bsmm"), its
// reads of dX made by the Tensor Memory Accelerator (TMA):
//   dX (C*R*S, N*H*W) -> dx, each dx[n, c, h, w] the sum over
//   taps t = r*S + s of dX[(cb*trs + t)*bC + ci, (n, h - r + pt, w - s + pl)]
//   (c = cb*bC + ci), 0 where that pixel lies outside the image, in f32, in
//   tap order starting from 0.f, rounded once to dX's dtype.
// dX is stored in the NC orientation bsmm_bprop writes: element (row, p) at
// p * C*R*S + row, a contiguous (N*H*W, C*R*S) array, read here in place.
// dx is written through its strides: element (n, c, h, w) at n*sn + c*sc +
// h*W + w, so an NCHW image (sc = H*W, sn = C*H*W), the conv's dI, and a
// channel-major (C, N*H*W) array (sc = N*H*W, sn = H*W) come out alike,
// with no transposing copy.
//
// Replaces the TPU kernel col2im (blocksparse_tpu/kernels/im2col.py), which
// folds each tap back with a lane roll and a boundary mask.
//
// Bound on the H100: bytes.  It reads dX once and writes dx once, (trs + 1) *
// C * N*H*W elements: at the conv bench's C=512 (N 32, 32x32, 3x3, b32,
// bf16) 302 MB + 34 MB, 0.100 ms at 3.35 TB/s; 0.200 ms at C=1024 and 0.401
// ms at C=2048.  The sums are a few adds an element: nothing else binds.
//
// Design.  The contiguous dX is a 4-D tensor (N, H, W, C*trs), which one TMA
// tensor map describes (built on the host by cuTensorMapEncodeTiled, got
// through cudaGetDriverEntryPoint, so nothing links libcuda; passed as a
// __grid_constant__ parameter).  A tile is (channel block cb, image n, TH x
// TW output pixels).  For tap t, one tiled TMA load brings the box {bC, TW,
// TH, 1} at ((cb*trs + t)*bC, w0 - dw_t, h0 - dh_t, n), dh_t = r - pt, dw_t =
// s - pl: element [py][px][ci] is the tap's term for output (h0 + py, w0 +
// px).  TMA fills the coordinates outside the tensor, negative ones
// included, with zeros: exactly the padding the previous kernel masked by
// hand.  Completion is counted on one mbarrier a ring slot.  A slot is
// refilled only after every thread's reads of it (the generic proxy) are
// ordered before the TMA write (the async proxy), by fence.proxy.async and
// a barrier: without the fence a refill now and then overwrote a box still
// being read (a few calls in a hundred at the conv bench's f32 shape).  The
// thread
// blocks are persistent (two resident an SM): each walks its tiles, and one
// thread keeps `stages` boxes of its (tile, tap) sequence in flight, across
// tile boundaries; at b128 in f32 a tile's nine boxes would not fit at once,
// so the ring holds single taps and the taps of a tile pass through it in
// order.  Each thread owns ITEMS (channel ci, run of VEC consecutive pixels
// of a tile row) items, the same offsets in every tile, and adds the trs
// taps into f32 registers in tap order from 0.f (the zero-filled taps
// included, as col2im_plain's sum over the padded image is), then rounds
// once and stores each run with one 16-byte store along the pixels of dx (a
// scalar store a pixel where W or dx's strides are not a multiple of VEC).  So the result
// equals col2im_plain's bit for bit: in f32 exactly, in bf16/f16 the same f32
// sum rounded once.  No atomics.  Lanes take consecutive channels: from bC 32
// a warp reads one pixel's run of channels, free of bank conflicts without a
// swizzle; at bC 8 and 16 a warp spans 4 or 2 runs whose pixels sit 128 or
// 256 bytes apart (box rows of 16-64 bytes, narrower than the TMA swizzle
// spans that could separate them), so each thread walks its run rotated by
// its run index, which puts the runs in distinct banks.
//
// Tile shape and ring depth per (bC, dtype, H, W) come from col2im_tile in
// kernels/im2col.py: a box of at most 16 KB (TH*TW*bC*elem; ITEMS = 4 items a
// thread of 256), TW a multiple of VEC covering W where it can (at most 256
// pixels, a TMA box dimension's limit), TH the rows left, six stages.  The
// host checks the TMA limits: box dimensions <= 256, the box's inner extent a
// multiple of 16 bytes (bC*elem >= 16), global strides a multiple of 16 bytes
// (C*trs*elem; C % 8 == 0 as bC divides C), dX 16-byte aligned.
//
// Prediction (written before the first timed run; NVIDIA H100 80GB HBM3,
// 3x3, b32, bf16, N 32, 32x32): 0.13-0.16 ms at C=512 (bound 0.100, target
// <= 0.20, the previous kernel 0.478), 0.26-0.32 ms at C=1024 (bound 0.200)
// and 0.52-0.64 ms at C=2048 (bound 0.401): about 2.2-2.6 TB/s, the rate of a
// streaming read of 64-byte runs, each box a gather of TH*TW of them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;              // (channel, pixel run) items a thread owns
constexpr int MAX_BOX = 16384;        // bytes of one tap's box: ITEMS * THREADS * 16
constexpr int MAX_STAGES = 8;
constexpr int MAX_BOX_DIM = 256;      // TMA's limit on a box dimension

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }

// one run of 16 bytes, rounded once
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(__half* p, const float (&v)[8]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// the box at (c0, c1, c2, c3) of the tensor map into shared memory at dst,
// its bytes counted on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// dynamic shared memory: 128 bytes of slack to align the ring, the ring of
// `stages` boxes, one mbarrier a slot
size_t smem_bytes(int stages, size_t box_bytes) {
  return 128 + stages * (box_bytes + sizeof(uint64_t));
}

template <typename T, int BC>
__global__ void __launch_bounds__(THREADS)
col2im_tma_kernel(const __grid_constant__ CUtensorMap dX, T* __restrict__ out, long long sc,
                  long long sn, int H, int W, int S, int trs, int pt, int pl, int TH, int TW,
                  int ncb, int ntw, int nth, int tiles, int stages, int vec) {
  constexpr int VEC = 16 / sizeof(T);     // pixels of one 16-byte store
  constexpr bool ROT = BC < 32;           // a warp spans several runs
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int box = BC * TH * TW;           // elements of one tap's box
  T* ring = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)stages * box * sizeof(T));
  const int tid = threadIdx.x;
  const int bid = blockIdx.x, grid = gridDim.x;
  const int mine = tiles > bid ? (tiles - 1 - bid) / grid + 1 : 0;
  const int total = mine * trs;           // the (tile, tap) boxes this block reads

  // tile -> (cb, tw, th, n), channel blocks fastest: the blocks at work at
  // once read the same pixels' rows of dX
  auto where = [&](int q, int& cb, int& tw, int& th, int& n) {
    int rest = bid + (q / trs) * grid;
    cb = rest % ncb, rest /= ncb;
    tw = rest % ntw, rest /= ntw;
    th = rest % nth, n = rest / nth;
  };
  // box q of the sequence into slot q % stages (one thread)
  auto issue = [&](int q) {
    int cb, tw, th, n;
    where(q, cb, tw, th, n);
    const int t = q % trs, slot = q % stages;
    mbar_expect_tx(full + slot, box * sizeof(T));
    tma_load_4d(ring + (size_t)slot * box, &dX, full + slot, (cb * trs + t) * BC,
                tw * TW - (t % S - pl), th * TH - (t / S - pt), n);
  };
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < stages && q < total; ++q) issue(q);

  // this thread's items: (channel ci, run of VEC pixels), at the same box
  // offsets in every tile; rot, the rotation of its walk along the run
  const int live = BC * (TH * TW / VEC);
  int off[ITEMS], rot[ITEMS];
  float acc[ITEMS][VEC];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int item = tid + i * THREADS, run = item / BC;
    off[i] = run * VEC * BC + item % BC;
    rot[i] = ROT ? run % VEC : 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  }

  for (int q = 0; q < total; ++q) {
    const int slot = q % stages;
    mbar_wait(full + slot, (q / stages) & 1);
    const T* b = ring + (size_t)slot * box;
    // acc[i][j] holds pixel (j + rot[i]) % VEC of item i's run
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (tid + i * THREADS < live) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int jj = ROT ? (j + rot[i]) & (VEC - 1) : j;
          acc[i][j] += to_f32(b[off[i] + jj * BC]);
        }
      }
    // every thread is done with the slot: its reads (the generic proxy)
    // ordered before the TMA (the async proxy) that refills it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && q + stages < total) issue(q + stages);
    if (q % trs != trs - 1) continue;

    // the tile's last tap: round each run once and store it along dx's pixels
    int cb, tw, th, n;
    where(q, cb, tw, th, n);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int item = tid + i * THREADS;
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = acc[i][j], acc[i][j] = 0.f;
      if (item >= live) continue;
      if constexpr (ROT) {  // undo the rotation: v[m] = pixel m
#pragma unroll
        for (int s = 1; s < VEC; s <<= 1)
          if (rot[i] & s) {
            float u[VEC];
#pragma unroll
            for (int m = 0; m < VEC; ++m) u[m] = v[(m - s) & (VEC - 1)];
#pragma unroll
            for (int m = 0; m < VEC; ++m) v[m] = u[m];
          }
      }
      const int lp = item / BC * VEC;
      const int h = th * TH + lp / TW, w = tw * TW + lp % TW;
      if (h >= H) continue;
      T* o = out + (long long)(cb * BC + item % BC) * sc + (long long)n * sn + (long long)h * W + w;
      if (vec) {
        if (w < W) store16(o, v);
      } else {
#pragma unroll
        for (int m = 0; m < VEC; ++m)
          if (w + m < W) store1(o + m, v[m]);
      }
    }
  }
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<Encode>(p);
  }
  return fn;
}

template <typename T> CUtensorMapDataType map_type();
template <> CUtensorMapDataType map_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> CUtensorMapDataType map_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

template <typename T, int BC>
cudaError_t launch(const void* dX, void* dx, int C, int N, int H, int W, int R, int S, int pt,
                   int pl, int TH, int TW, int stages, long long sc, long long sn,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t box_bytes = (size_t)BC * TH * TW * sizeof(T);
  if (TH < 1 || TH > MAX_BOX_DIM || TW < VEC || TW > MAX_BOX_DIM || TW % VEC ||
      box_bytes > MAX_BOX || stages < 2 || stages > MAX_STAGES)
    return cudaErrorInvalidValue;
  const int trs = R * S;
  const cuuint64_t CT = (cuuint64_t)C * trs, e = sizeof(T);
  CUtensorMap map;
  const cuuint64_t dims[4] = {CT, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {CT * e, CT * e * W, CT * e * W * H};
  const cuuint32_t boxdim[4] = {(cuuint32_t)BC, (cuuint32_t)TW, (cuuint32_t)TH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  Encode encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (encode(&map, map_type<T>(), 4, const_cast<void*>(dX), dims, strides, boxdim, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  auto kernel = col2im_tma_kernel<T, BC>;
  const size_t bytes = smem_bytes(stages, box_bytes);
  static unsigned ready = 0;  // the opt-in, once per device, at the most any call takes
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_STAGES, MAX_BOX));
    if (err != cudaSuccess) return err;
    if (dev < 32) ready |= 1u << dev;
  }
  int sms = 0, resident = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, THREADS, bytes);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int ncb = C / BC, ntw = (W + TW - 1) / TW, nth = (H + TH - 1) / TH;
  const long long tiles = (long long)ncb * ntw * nth * N;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid = tiles < (long long)sms * resident ? tiles : (long long)sms * resident;
  const int vec = W % VEC == 0 && sc % VEC == 0 && sn % VEC == 0 &&
                  reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  kernel<<<(unsigned)grid, THREADS, bytes, stream>>>(map, static_cast<T*>(dx), sc, sn, H, W, S,
                                                     trs, pt, pl, TH, TW, ncb, ntw, nth,
                                                     (int)tiles, stages, vec);
  return cudaGetLastError();
}

#define COL2IM_ARGS dX, dx, C, N, H, W, R, S, pt, pl, TH, TW, stages, sc, sn, s

template <typename T>
cudaError_t dispatch(int bC, const void* dX, void* dx, int C, int N, int H, int W, int R, int S,
                     int pt, int pl, int TH, int TW, int stages, long long sc, long long sn,
                     cudaStream_t s) {
  switch (bC) {
    case 8: return launch<T, 8>(COL2IM_ARGS);
    case 16: return launch<T, 16>(COL2IM_ARGS);
    case 32: return launch<T, 32>(COL2IM_ARGS);
    case 64: return launch<T, 64>(COL2IM_ARGS);
    case 128: return launch<T, 128>(COL2IM_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  dX (C*R*S, N*H*W) stored NC
// (a contiguous (N*H*W, C*R*S) array, 16-byte aligned) in; dx out, element
// (n, c, h, w) at n*sn + c*sc + h*W + w (elements).  TH x TW output pixels a
// tile and `stages` ring slots, as
// col2im_tile (kernels/im2col.py) picks them.  Scope: stride 1, dilation 1,
// output dims = input dims, 0 <= pt < R, 0 <= pl < S, bC in {8, 16, 32, 64,
// 128} dividing C.  Returns a cudaError_t (0 = launched).
extern "C" int col2im_fwd(int dtype, const void* dX, void* dx, int C, int N, int H, int W, int R,
                          int S, int pt, int pl, int bC, int TH, int TW, int stages, long long sc,
                          long long sn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || N <= 0 || H <= 0 || W <= 0 || bC <= 0 || C % bC || pt < 0 || pt >= R ||
      pl < 0 || pl >= S || (long long)N * H * W > 0x7fffffffLL || sc < 0 || sn < 0 ||
      reinterpret_cast<uintptr_t>(dX) % 16)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(bC, COL2IM_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bC, COL2IM_ARGS);
  if (dtype == 2) return dispatch<__half>(bC, COL2IM_ARGS);
  return cudaErrorInvalidValue;
}
