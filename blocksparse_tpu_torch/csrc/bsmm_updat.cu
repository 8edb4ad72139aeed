// Block-sparse matmul weight gradient (updat) in the NC orientation, f32:
//   dw[e] (B, B) = x[:, c_e*B:(c_e+1)*B]^T . dy[:, k_e*B:(k_e+1)*B],
// summed over the N rows, for every layout block e, in f32.
//
// Replaces, for f32 inputs, the TPU kernel updat_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) and, for canonical (blocks, B, B)
// weights, updat_pallas_grouped and updat_pallas, which compute the same dw
// with other MXU tilings.  bf16 and f16 run bsmm_updat_mma.cu on the tensor
// cores.  f32 runs here in full fp32 on the CUDA cores (no TF32): the
// reference's f32 dots are exact.
//
// The sum order: each output is one fmaf chain over the N rows in ascending
// order, starting from 0; N is not split, so no second pass is needed and
// two runs give the same bits.
//
// The host plan (updat_plan in kernels/bsmm.py, the one the tensor-core
// kernel runs) cuts the layout's blocks into groups that share one operand
// tile: the blocks of one x block-row (the shared operand Q is x, the other
// operand P is dy), or of one dy block-column (Q = dy, P = x), G = 256 / B
// blocks a group.  A group's slots are split between SPLIT = 2 thread
// blocks, each owning G / 2 of them (a dense 2048 x 512 layer at b32 makes
// 256 thread blocks, not 128 on 132 SMs).  A cp.async ring of STAGES stages
// of TN token rows brings Q's (TN, B) tile and its slots' (TN, B) tiles of
// P side by side, so Q's rows are read once for G / 2 blocks.  It computes
// D (B x 128) = Q_tile^T . P_slots with each thread RM x RN = 4 x 8 (b8,
// b16) or 8 x 8 (b32-b128) outputs: both operands lie with the token rows
// outermost, so a thread reads float4s of Q's and P's staged rows at each
// token row, with no transposes (32 or 64 FMAs for 12 or 16 floats read);
// the lanes of a warp form a 4 x 8 tile of threads (2 x 16 at b8), so each
// 16-byte read of a warp touches one 128-byte line of shared memory or
// broadcasts.  Slot t of D is dw[e] when Q is x (stored as is, float4 along
// its rows), dw[e]^T when Q is dy (stored transposed, float4 along Q's
// columns).  Token rows past N and empty slots are zero-filled by the copy.
//
// Bound on the H100: operations.  At the MoE LM's bsmm2 (N 2,560, 2048 ->
// 512 dense b32, 1,024 blocks) a call is 5.4 GFLOP (0.080 ms at 67 TFLOP/s)
// against ~30 MB of traffic; at the sparse LSTM's (N 128, 2,428 blocks)
// 0.64 GFLOP (0.0095 ms).
#include "mma_sm90.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int TN = 16;             // token rows a ring stage
constexpr int GROUP_COLS = 256;    // columns of P a group holds: G slots of B
constexpr int PCOLS = 128;         // of them, the columns a thread block owns
constexpr int SPLIT = GROUP_COLS / PCOLS;  // thread blocks a group

template <int B> struct Cfg {
  static constexpr int G = GROUP_COLS / B, GB = PCOLS / B;  // slots of a group, of a block
  static constexpr int RM = B <= 16 ? 4 : 8;  // outputs a thread along Q's columns
  static constexpr int RN = 8;                // along P's
  static constexpr int TI = B / RM, TJ = PCOLS / RN;
  static constexpr int THREADS = TI * TJ;
  static constexpr int LI = TI < 4 ? TI : 4;  // lanes of a warp: LI by LJ threads
  static constexpr int LJ = 32 / LI;
  static constexpr int Q_ELEMS = TN * B;
  static constexpr int ELEMS = Q_ELEMS + TN * PCOLS;  // one ring stage
  static constexpr size_t SMEM = (size_t)STAGES * ELEMS * sizeof(float);
  static_assert(TJ % LJ == 0 && THREADS % (PCOLS / 4) == 0, "thread tiles");
};

// p (N, ldp), q (N, ldq); group g: Q block grp_q[g], slots slot_p[g*G + t]
// (P block, -1 past the group's last entry) writing block slot_e[g*G + t].
template <int B, bool BY_C>
__global__ void __launch_bounds__(Cfg<B>::THREADS)
bsmm_updat_nc_kernel(const float* __restrict__ p, const float* __restrict__ q,
                     const int* __restrict__ grp_q, const int* __restrict__ slot_p,
                     const int* __restrict__ slot_e, float* __restrict__ dw, int N, int ldp,
                     int ldq) {
  using F = Cfg<B>;
  constexpr int G = F::G, RM = F::RM, RN = F::RN, TI = F::TI, TJ = F::TJ;
  constexpr int THREADS = F::THREADS;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x, grp = blockIdx.x / SPLIT;
  const int lane = tid % 32, warp = tid / 32;
  constexpr int WJ = TJ / F::LJ;
  const int ti = (warp / WJ) * F::LI + lane / F::LJ;
  const int tj = (warp % WJ) * F::LJ + lane % F::LJ;
  const int stages = (N + TN - 1) / TN;
  const int* sp = slot_p + (size_t)grp * G + blockIdx.x % SPLIT * F::GB;
  const int* se = slot_e + (size_t)grp * G + blockIdx.x % SPLIT * F::GB;

  // every P chunk of this thread lies in one 16-byte column of one slot:
  // one LUT read for the whole walk
  const int pc = tid % (PCOLS / 4) * 4;
  const int pblk = sp[pc / B];
  const float* psrc = p + (pblk >= 0 ? (size_t)pblk * B + pc % B : 0);
  const float* qsrc = q + (size_t)grp_q[grp] * B;

  auto load = [&](int s, int slot) {
    float* qs = ring + slot * F::ELEMS;
    float* ps = qs + F::Q_ELEMS;
    const int n0 = s * TN;
#pragma unroll
    for (int i = 0; i < TN * (PCOLS / 4) / THREADS; ++i) {
      const int r = tid / (PCOLS / 4) + i * (THREADS / (PCOLS / 4));
      const bool v = pblk >= 0 && n0 + r < N;
      cp_async16(smem_addr(ps + r * PCOLS + pc), v ? psrc + (size_t)(n0 + r) * ldp : p, v);
    }
    constexpr int QCH = TN * B / 4;
#pragma unroll
    for (int i = 0; i < (QCH + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (QCH % THREADS == 0 || c < QCH) {
        const int r = c / (B / 4), c4 = c % (B / 4) * 4;
        const bool v = n0 + r < N;
        cp_async16(smem_addr(qs + r * B + c4), v ? qsrc + (size_t)(n0 + r) * ldq + c4 : q, v);
      }
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.f;

  // A thread's Q columns: ti*4 + u*TI*4 + (0..3); its P columns tj*4 +
  // v*TJ*4 + (0..3).  Token rows in ascending order.
  auto compute = [&](int slot) {
    const float* qs = ring + slot * F::ELEMS;
    const float* ps = qs + F::Q_ELEMS;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      float a[RM], b[RN];
#pragma unroll
      for (int u = 0; u < RM / 4; ++u) {
        const float4 t = *reinterpret_cast<const float4*>(qs + n * B + ti * 4 + u * TI * 4);
        a[4 * u] = t.x;
        a[4 * u + 1] = t.y;
        a[4 * u + 2] = t.z;
        a[4 * u + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < RN / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(ps + n * PCOLS + tj * 4 + v * TJ * 4);
        b[4 * v] = t.x;
        b[4 * v + 1] = t.y;
        b[4 * v + 2] = t.z;
        b[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
    compute(s % STAGES);
  }
  cp_async_wait<0>();

  // acc[4u + a][4v + b]: Q column ti*4 + u*TI*4 + a, P column tj*4 + v*TJ*4 + b
#pragma unroll
  for (int v = 0; v < RN / 4; ++v) {
    const int pcol = tj * 4 + v * TJ * 4;
    const int e = se[pcol / B];
    if (e < 0) continue;
    float* ob = dw + (size_t)e * B * B;
    const int jp = pcol % B;
#pragma unroll
    for (int u = 0; u < RM / 4; ++u) {
      const int iq = ti * 4 + u * TI * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if constexpr (BY_C) {  // Q = x: dw[e][iq + a][jp .. jp + 3]
          *reinterpret_cast<float4*>(ob + (iq + a) * B + jp) =
              make_float4(acc[4 * u + a][4 * v], acc[4 * u + a][4 * v + 1],
                          acc[4 * u + a][4 * v + 2], acc[4 * u + a][4 * v + 3]);
        } else {               // Q = dy: dw[e][jp + a][iq .. iq + 3]
          *reinterpret_cast<float4*>(ob + (jp + a) * B + iq) =
              make_float4(acc[4 * u][4 * v + a], acc[4 * u + 1][4 * v + a],
                          acc[4 * u + 2][4 * v + a], acc[4 * u + 3][4 * v + a]);
        }
      }
    }
  }
}

template <int B, bool BY_C>
cudaError_t launch(const float* p, const float* q, const int* grp_q, const int* slot_p,
                   const int* slot_e, float* dw, int N, int ldp, int ldq, int groups,
                   cudaStream_t stream) {
  auto kernel = bsmm_updat_nc_kernel<B, BY_C>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, Cfg<B>::SMEM, ready);
  if (err != cudaSuccess) return err;
  kernel<<<groups * SPLIT, Cfg<B>::THREADS, Cfg<B>::SMEM, stream>>>(p, q, grp_q, slot_p, slot_e, dw, N,
                                                            ldp, ldq);
  return cudaGetLastError();
}

template <int B, bool BY_C>
cudaError_t info(int* out) {
  auto kernel = bsmm_updat_nc_kernel<B, BY_C>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, Cfg<B>::SMEM, ready);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, Cfg<B>::THREADS,
                                                      Cfg<B>::SMEM);
  out[0] = Cfg<B>::THREADS;
  out[1] = static_cast<int>(Cfg<B>::SMEM + attr.sharedSizeBytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = resident;
  return err;
}

#define UPDAT_ARGS p, q, grp_q, slot_p, slot_e, dw, N, ldp, ldq, groups, s

template <int B>
cudaError_t launch_dir(int by_c, const float* p, const float* q, const int* grp_q,
                       const int* slot_p, const int* slot_e, float* dw, int N, int ldp, int ldq,
                       int groups, cudaStream_t s) {
  return by_c ? launch<B, true>(UPDAT_ARGS) : launch<B, false>(UPDAT_ARGS);
}

}  // namespace

// dtype: 0 = float32; any other returns cudaErrorInvalidValue (bf16 and f16
// run bsmm_updat_mma.cu).  p (N, ldp) is the operand with one tile a slot,
// q (N, ldq) the one each group shares; by_c = 1 when q is x (the groups are
// x block-rows).  grp_q (groups,), slot_p and slot_e (groups, 256 / bsize)
// int32: updat_plan's arrays.  dw: f32 (blocks, bsize, bsize).  p, q and dw
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_updat_nc(int dtype, int bsize, int by_c, const void* p, const void* q,
                             const int* grp_q, const int* slot_p, const int* slot_e, void* dw,
                             int N, int ldp, int ldq, int groups, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* qf = static_cast<const float*>(q);
  float* dwf = static_cast<float*>(dw);
#define UPDAT_CALL(B) \
  launch_dir<B>(by_c, pf, qf, grp_q, slot_p, slot_e, dwf, N, ldp, ldq, groups, s)
  switch (bsize) {
    case 8: return UPDAT_CALL(8);
    case 16: return UPDAT_CALL(16);
    case 32: return UPDAT_CALL(32);
    case 64: return UPDAT_CALL(64);
    case 128: return UPDAT_CALL(128);
    default: return cudaErrorInvalidValue;
  }
#undef UPDAT_CALL
}

// out[5]: threads, shared memory bytes a block, registers a thread, local
// (spilled) bytes a thread, blocks an SM holds, of the kernel for (bsize,
// by_c).  Returns a cudaError_t.
extern "C" int bsmm_updat_nc_info(int bsize, int by_c, int* out) {
  switch (bsize) {
    case 8: return by_c ? info<8, true>(out) : info<8, false>(out);
    case 16: return by_c ? info<16, true>(out) : info<16, false>(out);
    case 32: return by_c ? info<32, true>(out) : info<32, false>(out);
    case 64: return by_c ? info<64, true>(out) : info<64, false>(out);
    case 128: return by_c ? info<128, true>(out) : info<128, false>(out);
    default: return cudaErrorInvalidValue;
  }
}
