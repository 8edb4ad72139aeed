// Block-sparse matmul weight gradient (updat) on Hopper's tensor cores, bf16
// and f16, in the NC orientation:
//   dw[e] (B, B) = x[:, c_e*B:(c_e+1)*B]^T . dy[:, k_e*B:(k_e+1)*B],
// summed over the N token rows, for every layout block e, in f32.
//
// Replaces, for bf16 and f16 inputs, the TPU kernels updat_pallas_dense_tile
// and, for canonical (blocks, B, B) weights, updat_pallas_grouped and
// updat_pallas (blocksparse_tpu/kernels/bsmm.py).  f32 inputs stay on
// bsmm_updat.cu, in full fp32 on the CUDA cores: the reference's f32 dots
// are Precision.HIGHEST, and the tensor cores would round them to TF32.
//
// The host plan (updat_plan in kernels/bsmm.py) cuts the layout's blocks
// into groups that share one operand tile: the blocks of one x block-row c
// (the shared operand Q is x, the other operand P is dy), or of one dy
// block-column k (Q = dy, P = x), whichever axis gives fewer groups.  A
// group holds up to G = 256 / B blocks.  One thread block owns one (group,
// run of N): it stages Q's tile once and P's G tiles side by side, and
// keeps the G blocks' accumulators in registers.  Per token row this reads
// (1 + G) block rows for G blocks, where one thread block per layout block
// reads 2 per block: about half the bytes through L2.
//
// Mapping onto mma.sync.m16n8k16 with f32 accumulators:
//   M = the G slots' P columns side by side (256 rows: slot t, column r);
//   N = Q's B columns;
//   K = the token rows n, TN = 32 of them a ring stage.
// So the thread block computes D (256 x B) = P_group^T . Q_tile, slot t's
// rows being (P block)^T . (Q block): dw[e] when P = x (stored as is), dw[e]^T
// when P = dy (stored transposed, TRANS_OUT).  Both operands arrive with the
// token rows outermost, i.e. K-major for the mma, so ldmatrix.trans reads
// both: A (P) as 8x8 matrices of (k rows, m columns), B (Q) as (k, n), the
// layout fprop's W has in bsmm_xprop_mma.cu.  Rows are padded by 16 bytes so
// the eight row addresses of an ldmatrix fall in distinct banks (b8's
// 16-byte Q rows need none).
//
// cp.async copies 16 bytes a thread into a ring of STAGES slots, so the next
// stages are in flight while the warps run the mma of this one; one barrier
// a stage.  Token rows past the run's end and slots past the group's last
// entry are zero-filled by the copy (src-size 0), so the mma loop has no
// branch; a warp whose slots are all empty skips its mma.  Eight warps split
// D into WM x WN tiles, each warp owning whole slots.  Every thread reads
// its P column's LUT entry once for the whole walk.
//
// The N split.  Where the groups alone would leave the card's SMs idle, the
// rule updat_splits (kernels/bsmm.py) cuts N into S runs of `rows` rows; run
// s writes its f32 partial dw into out[s], and bsmm_updat_reduce_nc sums the
// partials in the order s = 0 .. S-1.  No atomics: each output's sum runs in
// a fixed order (stage by stage, k16 step by k16 step, then run by run), so
// two runs give identical bits.  bf16 x bf16 and f16 x f16 products are
// exact in f32; only the order of the sum differs from the plain version.
// Thread blocks of one run of N are launched together (the group runs
// fastest), so that run's x and dy rows come from device memory about once.
//
// Bound on the H100: at the LM's training shape (N = 16384, b32, 558 blocks,
// 512 -> 2048) a call is 18.7 GFLOP (0.019 ms of bf16 tensor-core work)
// against 86 MB of inputs and outputs (0.0257 ms): bound by bytes.  This
// design reads P's tiles once per block and Q's once per group, N * B * 2 *
// (blocks + groups) bytes from L2 (0.66 GB there), which is what it spends
// beyond the bound.
#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS, STAGES = 4;
constexpr int TN = 32;      // token rows a ring stage
constexpr int MROWS = 256;  // rows of D: G slots of B columns

// Warps over D (256 x B): WM along the slots, WN along Q's columns.
template <int B> struct Tile;
template <> struct Tile<8>   { static constexpr int WM = 8, WN = 1; };
template <> struct Tile<16>  { static constexpr int WM = 8, WN = 1; };
template <> struct Tile<32>  { static constexpr int WM = 8, WN = 1; };
template <> struct Tile<64>  { static constexpr int WM = 4, WN = 2; };
template <> struct Tile<128> { static constexpr int WM = 2, WN = 4; };

// One ring slot, in elements: P's TN rows of the G slots side by side
// (padded), then Q's TN rows of B.
template <int B> struct Ring {
  static constexpr int G = MROWS / B;
  static constexpr int PLD = MROWS + 8;
  static constexpr int QLD = B == 8 ? B : B + 8;
  static constexpr int P_ELEMS = TN * PLD;
  static constexpr int ELEMS = P_ELEMS + TN * QLD;
};

template <typename T, int B>
constexpr size_t smem_bytes() {
  return STAGES * Ring<B>::ELEMS * sizeof(T);
}

// p (N, ldp), q (N, ldq); group g: Q block grp_q[g], slots slot_p[g*G + t]
// (P block, -1 past the group's last entry) writing block slot_e[g*G + t].
// Thread block (g, s) sums rows [s*rows, min(N, (s+1)*rows)) into
// out[s] (blocks, B, B).
template <typename T, int B, bool TRANS_OUT>
__global__ void __launch_bounds__(THREADS)
bsmm_updat_mma_kernel(const T* __restrict__ p, const T* __restrict__ q,
                      const int* __restrict__ grp_q, const int* __restrict__ slot_p,
                      const int* __restrict__ slot_e, float* __restrict__ out, int N, int ldp,
                      int ldq, int groups, int rows, int blocks) {
  using R = Ring<B>;
  constexpr int G = R::G, PLD = R::PLD, QLD = R::QLD;
  constexpr int WN = Tile<B>::WN;
  constexpr int MW = MROWS / Tile<B>::WM, NW = B / WN;  // a warp's rows and columns of D
  constexpr int MT = MW / 16, NT = NW / 8;              // its m16 and n8 tiles
  constexpr int BCH = B / 8;                            // 16-byte chunks of a block row
  constexpr int PCH = MROWS / 8;                        // of a P stage row
  static_assert(THREADS % PCH == 0 && (TN * PCH) % THREADS == 0, "P staging");
  static_assert(MW % B == 0, "a warp owns whole slots");
  static_assert(NT == 1 || NT % 2 == 0, "n8 tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int grp = blockIdx.x % groups, run = blockIdx.x / groups;
  const int n_begin = run * rows;
  const int n_end = min(N, n_begin + rows);
  const int stages = n_end > n_begin ? (n_end - n_begin + TN - 1) / TN : 0;
  const int* sp = slot_p + (size_t)grp * G;
  const int* se = slot_e + (size_t)grp * G;
  // a group's slots are filled from 0: the warp's first slot says whether
  // any of its slots holds a block
  const bool live = sp[wm * MW / B] >= 0;

  // every P chunk of this thread lies in one 16-byte column of one slot:
  // one LUT read for the whole walk
  const int pkc = tid % PCH;
  const int pblk = sp[pkc / BCH];
  const T* psrc = p + (pblk >= 0 ? (size_t)pblk * B + (pkc % BCH) * 8 : 0);
  const T* qsrc = q + (size_t)grp_q[grp] * B;

  // Stage s (TN token rows from n_begin + s*TN) into ring slot `slot`.
  auto load = [&](int s, int slot) {
    T* ps = ring + slot * R::ELEMS;
    T* qs = ps + R::P_ELEMS;
    const int n0 = n_begin + s * TN;
#pragma unroll
    for (int i = 0; i < TN * PCH / THREADS; ++i) {
      const int r = tid / PCH + i * (THREADS / PCH);
      const bool v = pblk >= 0 && n0 + r < n_end;
      cp_async16(smem_addr(ps + r * PLD + pkc * 8), v ? psrc + (size_t)(n0 + r) * ldp : p, v);
    }
    constexpr int QCH = TN * BCH;
#pragma unroll
    for (int i = 0; i < (QCH + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (QCH % THREADS == 0 || c < QCH) {
        const int r = c / BCH, kc = c % BCH;
        const bool v = n0 + r < n_end;
        cp_async16(smem_addr(qs + r * QLD + kc * 8),
                   v ? qsrc + (size_t)(n0 + r) * ldq + kc * 8 : q, v);
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

  // The mma of one ring slot: TN / 16 k16 steps over the warp's tiles.
  auto compute = [&](int slot) {
    const T* ps = ring + slot * R::ELEMS;
    const T* qs = ps + R::P_ELEMS;
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < TN; kk += 16) {
      // A: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
      // (m 8-15, k 8-15), each stored as 8 k rows of 8 m
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(a[mt], smem_addr(ps + (kk + (mat >> 1) * 8 + (lane & 7)) * PLD + wm * MW +
                                   mt * 16 + (mat & 1) * 8));
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        // lanes 0-7 address k rows 0-7, lanes 8-15 k 8-15
        ldsm_x2_t(b[0], smem_addr(qs + (kk + (mat & 1) * 8 + (lane & 7)) * QLD + wn * NW));
      } else {
#pragma unroll
        for (int np = 0; np < NT; np += 2) {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          uint32_t r[4];
          const int n = wn * NW + np * 8 + (lane >> 4) * 8;
          const int k = kk + (mat & 1) * 8;
          ldsm_x4_t(r, smem_addr(qs + (k + (lane & 7)) * QLD + n));
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

  // epilogue: each slot's B x B tile straight from the registers (an
  // 8-row by 8-column piece of a tile fills whole 32-byte sectors either way)
  float* o = out + (size_t)run * blocks * B * B;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * MW + mt * 16 + h * 8 + g;
      const int e = se[m / B];
      if (e < 0) continue;
      const int r = m % B;
      float* ob = o + (size_t)e * B * B;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn * NW + nt * 8 + tg * 2;
        if constexpr (TRANS_OUT) {  // D holds dw[e]^T
          ob[c * B + r] = acc[mt][nt][2 * h];
          ob[(c + 1) * B + r] = acc[mt][nt][2 * h + 1];
        } else {
          *reinterpret_cast<float2*>(ob + r * B + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
}

template <typename T, int B, bool TRANS_OUT>
cudaError_t launch(const void* p, const void* q, const int* grp_q, const int* slot_p,
                   const int* slot_e, float* out, int N, int ldp, int ldq, int groups, int splits,
                   int rows, int blocks, cudaStream_t stream) {
  auto kernel = bsmm_updat_mma_kernel<T, B, TRANS_OUT>;
  constexpr size_t bytes = smem_bytes<T, B>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(groups) * static_cast<unsigned>(splits);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(p), static_cast<const T*>(q),
                                           grp_q, slot_p, slot_e, out, N, ldp, ldq, groups, rows,
                                           blocks);
  return cudaGetLastError();
}

#define UPDAT_ARGS p, q, grp_q, slot_p, slot_e, out, N, ldp, ldq, groups, splits, rows, blocks, s

template <typename T, int B>
cudaError_t launch_dir(int trans_out, const void* p, const void* q, const int* grp_q,
                       const int* slot_p, const int* slot_e, float* out, int N, int ldp, int ldq,
                       int groups, int splits, int rows, int blocks, cudaStream_t s) {
  return trans_out ? launch<T, B, true>(UPDAT_ARGS) : launch<T, B, false>(UPDAT_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans_out, const void* p, const void* q, const int* grp_q,
                     const int* slot_p, const int* slot_e, float* out, int N, int ldp, int ldq,
                     int groups, int splits, int rows, int blocks, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch_dir<T, 8>(trans_out, UPDAT_ARGS);
    case 16: return launch_dir<T, 16>(trans_out, UPDAT_ARGS);
    case 32: return launch_dir<T, 32>(trans_out, UPDAT_ARGS);
    case 64: return launch_dir<T, 64>(trans_out, UPDAT_ARGS);
    case 128: return launch_dir<T, 128>(trans_out, UPDAT_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

// dw = sum over s of parts[s], in the order s = 0 .. splits-1; n4 float4s a
// partial
__global__ void bsmm_updat_reduce_kernel(const float4* __restrict__ parts, float4* __restrict__ dw,
                                         int splits, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = parts[i];
  for (int s = 1; s < splits; ++s) {
    const float4 v = parts[(size_t)s * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  dw[i] = acc;
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (p and q alike); any other dtype returns
// cudaErrorInvalidValue.  p (N, ldp) is the operand with one tile a slot,
// q (N, ldq) the one each group shares; trans_out = 1 when q is x (the
// groups are x block-rows, D = dw^T).  grp_q (groups,), slot_p and slot_e
// (groups, 256 / bsize) int32: updat_plan's arrays.  out: f32 (splits,
// blocks, bsize, bsize), run s summing token rows [s*rows, (s+1)*rows)
// (rows a multiple of 32 when splits > 1).  p and q must be 16-byte
// aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_updat_mma_nc(int dtype, int bsize, int trans_out, const void* p,
                                 const void* q, const int* grp_q, const int* slot_p,
                                 const int* slot_e, void* out, int N, int ldp, int ldq,
                                 int groups, int splits, int rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* outf = static_cast<float*>(out);
#define UPDAT_CALL(T) \
  dispatch<T>(bsize, trans_out, p, q, grp_q, slot_p, slot_e, outf, N, ldp, ldq, groups, splits, \
              rows, blocks, s)
  if (dtype == 1) return UPDAT_CALL(__nv_bfloat16);
  if (dtype == 2) return UPDAT_CALL(__half);
  return cudaErrorInvalidValue;
#undef UPDAT_CALL
}

// The split's second pass: dw (n4 float4s) = parts[0] + parts[1] + ... in
// that order; parts f32 (splits, n4 float4s), both 16-byte aligned.
extern "C" int bsmm_updat_reduce_nc(const void* parts, void* dw, int splits, int n4,
                                    void* stream) {
  const int threads = 256;
  bsmm_updat_reduce_kernel<<<(n4 + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(parts), static_cast<float4*>(dw), splits, n4);
  return cudaGetLastError();
}
