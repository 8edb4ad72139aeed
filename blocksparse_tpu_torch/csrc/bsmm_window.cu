// Block-sparse matmul xprop with x streamed once per window slab, f32, NC
// orientation (feature_axis=1), b 8-128:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (TRANS).
//
// Replaces, for f32 inputs, the TPU kernel xprop_pallas_window
// (blocksparse_tpu/kernels/bsmm.py, body _xprop_window_kernel; bf16 and f16
// run bsmm_window_mma.cu on the tensor cores): a super-group of SG output groups
// keeps its f32 accumulators resident while x is streamed once per
// column window of WB block-rows.
//
// Plan (kernels/bsmm.py window_plan): a CSR over (super-group sg of SG
// output block-columns, input window win of WB block-rows, local output
// column lo).  ptr[(sg * nwin + win) * SG + lo] .. ptr[... + 1] are the
// entries (slot within the window, weight block) of output column
// sg * SG + lo that fall in window win, in ascending input order; the
// windows of one super-group follow each other, so each column's entries
// run in its LUT order.
//
// Design: one thread block owns one (N-tile of TN rows, sg).  Its SG x RM x
// RN f32 accumulators a thread stay in registers for the whole call (the
// loop over lo is unrolled, so every index into them is a constant).  It
// walks the windows in order; for a window that holds any of its entries it
// stages the x slab (TN x SLAB columns, transposed, f32) in shared memory
// once, then, column by column, stages up to EB = 128/B of the column's W
// blocks (128 contraction rows) between each pair of barriers and applies
// them from the staged slab.  Loads past C (a last window that does not
// divide C) and past N are guarded, not padded.  Each output's f32 sum
// runs over its entries in LUT order with the same fmaf chain from 0 as
// bsmm_fprop.cu's, so the result equals bsmm_fprop's bit for bit, and
// each output is written once, with no atomics; an empty column writes
// zeros.
//
// Sizes for the H100 (227 KB of shared memory a block, 228 KB an SM):
//   TN = 64 rows, SLAB = 256 columns (WB = 256 / B block-rows), EB * B =
//   128 staged W rows; bytes of shared memory = 4 * (256 * 68 + 128 * (B + 4)):
//   B    8: RM 2, RN 2, SG 16, 128 threads;  75,776 B
//   B   16: RM 4, RN 2, SG  8, 128 threads;  79,872 B
//   B   32: RM 4, RN 2, SG  8, 256 threads;  88,064 B
//   B   64: RM 4, RN 4, SG  4, 256 threads; 104,448 B
//   B  128: RM 4, RN 8, SG  2, 256 threads; 137,216 B
// so SG * RM * RN = 64 f32 accumulators a thread, and two blocks fit an SM
// up to b64.
//
// Bound on the H100: at the window's regime (random 8192^2, b32, d 0.25,
// N 256) a call is 2 * N * blocks * B^2 = 8.6 GFLOP against 41 MB (W read
// once per N-tile): bound by operations on the CUDA cores.  What the slab
// saves is x traffic: x is read once per (N-tile, super-group, window
// holding entries), not once per entry.
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

constexpr int TN = 64;      // rows of N a thread block owns
constexpr int SLAB = 256;   // x columns a window stages: WB = SLAB / B block-rows
constexpr int WDEPTH = 128; // W rows staged a barrier pair: EB = WDEPTH / B blocks
constexpr int XP = TN + 4;  // padded row of the transposed slab

template <int B> struct WinTile;
template <> struct WinTile<8>   { static constexpr int RM = 2, RN = 2, SG = 16; };
template <> struct WinTile<16>  { static constexpr int RM = 4, RN = 2, SG = 8; };
template <> struct WinTile<32>  { static constexpr int RM = 4, RN = 2, SG = 8; };
template <> struct WinTile<64>  { static constexpr int RM = 4, RN = 4, SG = 4; };
template <> struct WinTile<128> { static constexpr int RM = 4, RN = 8, SG = 2; };

template <int B> struct WinThreads {
  static constexpr int value = (TN / WinTile<B>::RM) * (B / WinTile<B>::RN);
};

template <int B> __host__ __device__ constexpr int win_eb() { return B < WDEPTH ? WDEPTH / B : 1; }
template <int B> __host__ __device__ constexpr int win_wp() { return B + 4; }
template <int B> __host__ __device__ constexpr size_t win_smem() {
  return sizeof(float) * ((size_t)SLAB * XP + (size_t)win_eb<B>() * B * win_wp<B>());
}

template <int R>
__device__ __forceinline__ void lds(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + r);
      v[r] = t.x; v[r + 1] = t.y; v[r + 2] = t.z; v[r + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + r);
      v[r] = t.x; v[r + 1] = t.y;
    }
  }
}

template <typename T, int B, bool TRANS>
__global__ void __launch_bounds__(WinThreads<B>::value)
bsmm_window_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ ptr, const int* __restrict__ ent_slot,
                   const int* __restrict__ ent_w, T* __restrict__ y, int N, int C, int K,
                   int nwin) {
  constexpr int RM = WinTile<B>::RM, RN = WinTile<B>::RN, SG = WinTile<B>::SG;
  constexpr int TC = B / RN;
  constexpr int THREADS = WinThreads<B>::value;
  constexpr int EB = win_eb<B>();
  constexpr int WP = win_wp<B>();
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [SLAB][XP]: xs[cc][m] = x[n0 + m][win * SLAB + cc]
  float* ws = smem + SLAB * XP;   // [EB * B][WP]: ws[k * B + ii][j] = W[w_k][ii][j] (or W^T)
  __shared__ int s_slot[EB];

  const int tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  const int n0 = blockIdx.x * TN;
  const int sg = blockIdx.y;
  const int n_out = K / B;

  float acc[SG][RM][RN];
#pragma unroll
  for (int lo = 0; lo < SG; ++lo)
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[lo][r][j] = 0.f;

  for (int win = 0; win < nwin; ++win) {
    const int* wp = ptr + ((size_t)sg * nwin + win) * SG;
    if (wp[0] == wp[SG]) continue;   // no entry of this super-group here
    // The slab, once.  Every thread has passed the barrier that closed the
    // last window's final batch, so nobody still reads the old slab.
    const int c0 = win * SLAB;
    for (int l = tid; l < TN * SLAB; l += THREADS) {
      const int m = l / SLAB, cc = l % SLAB;
      const int n = n0 + m, c = c0 + cc;
      xs[cc * XP + m] = (n < N && c < C) ? to_f32(x[(size_t)n * C + c]) : 0.f;
    }
#pragma unroll
    for (int lo = 0; lo < SG; ++lo) {
      const int le = wp[lo + 1];
      for (int e0 = wp[lo]; e0 < le; e0 += EB) {
        const int ne = min(EB, le - e0);
        if (tid < ne) s_slot[tid] = ent_slot[e0 + tid];
        for (int l = tid; l < ne * B * B; l += THREADS) {
          const int k = l / (B * B), rem = l % (B * B);
          const T* wb = w + (size_t)__ldg(ent_w + e0 + k) * B * B;
          if constexpr (TRANS) {
            // ws[k * B + ii][j] = W[j][ii]: read along W's rows
            ws[(k * B + rem % B) * WP + rem / B] = to_f32(wb[rem]);
          } else {
            ws[(k * B + rem / B) * WP + rem % B] = to_f32(wb[rem]);
          }
        }
        __syncthreads();
        for (int k = 0; k < ne; ++k) {
          const float* xk = xs + (size_t)s_slot[k] * B * XP + tr * RM;
          const float* wk = ws + k * B * WP + tc * RN;
#pragma unroll 8
          for (int ii = 0; ii < B; ++ii) {
            float a[RM], b[RN];
            lds<RM>(xk + ii * XP, a);
            lds<RN>(wk + ii * WP, b);
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int j = 0; j < RN; ++j)
                acc[lo][r][j] = fmaf(a[r], b[j], acc[lo][r][j]);
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int lo = 0; lo < SG; ++lo) {
    const int o = sg * SG + lo;
    if (o < n_out) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int n = n0 + tr * RM + r;
        if (n < N) {
          T* yr = y + (size_t)n * K + (size_t)o * B + tc * RN;
#pragma unroll
          for (int j = 0; j < RN; ++j) yr[j] = from_f32<T>(acc[lo][r][j]);
        }
      }
    }
  }
}

template <typename T, int B, bool TRANS>
cudaError_t launch_one(const void* x, const void* w, const int* ptr, const int* ent_slot,
                       const int* ent_w, void* y, int N, int C, int K,
                       cudaStream_t stream) {
  auto kernel = bsmm_window_kernel<T, B, TRANS>;
  constexpr size_t smem = win_smem<B>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int SG = WinTile<B>::SG;
  const int n_out = K / B;
  const int nwin = (C + SLAB - 1) / SLAB;
  dim3 grid((N + TN - 1) / TN, (n_out + SG - 1) / SG);
  kernel<<<grid, WinThreads<B>::value, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ptr, ent_slot, ent_w,
      static_cast<T*>(y), N, C, K, nwin);
  return cudaGetLastError();
}

#define WIN_ARGS x, w, ptr, ent_slot, ent_w, y, N, C, K, s

template <typename T, int B>
cudaError_t launch(int trans_w, const void* x, const void* w, const int* ptr,
                   const int* ent_slot, const int* ent_w, void* y, int N, int C, int K,
                   cudaStream_t s) {
  return trans_w ? launch_one<T, B, true>(WIN_ARGS) : launch_one<T, B, false>(WIN_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans_w, const void* x, const void* w, const int* ptr,
                     const int* ent_slot, const int* ent_w, void* y, int N, int C, int K,
                     cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(trans_w, WIN_ARGS);
    case 16: return launch<T, 16>(trans_w, WIN_ARGS);
    case 32: return launch<T, 32>(trans_w, WIN_ARGS);
    case 64: return launch<T, 64>(trans_w, WIN_ARGS);
    case 128: return launch<T, 128>(trans_w, WIN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 (float32) only: bf16 and f16 run on the tensor cores (bsmm_window_mma.cu);
// any other dtype returns cudaErrorInvalidValue.  x is (N, C), y (N, K);
// trans_w = 0 for fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  ptr
// holds ceil(K / bsize / SG) * ceil(C / 256) * SG + 1 offsets (SG of this
// bsize, as above).  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_window_nc(int dtype, int bsize, int trans_w, const void* x,
                              const void* w, const int* ptr, const int* ent_slot,
                              const int* ent_w, void* y, int N, int C, int K,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(bsize, trans_w, WIN_ARGS);
  return cudaErrorInvalidValue;
}
