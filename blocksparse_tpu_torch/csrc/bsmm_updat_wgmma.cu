// Block-sparse matmul weight gradient (updat) on Hopper's warpgroup
// tensor-core products (wgmma) fed by TMA, bf16 and f16, in the NC
// orientation:
//   dw[e] (B, B) = x[:, c_e*B:(c_e+1)*B]^T . dy[:, k_e*B:(k_e+1)*B],
// summed over the N token rows, for every layout block e, in f32.
// Block sizes 32, 64 and 128; b8 and b16 stay on bsmm_updat_mma.cu (a
// block's 16- or 32-byte rows are narrower than this kernel's 64-byte
// swizzled boxes).
//
// Replaces, for bf16 and f16 inputs and canonical (blocks, B, B) weights,
// the TPU kernels updat_pallas_dense_tile, updat_pallas_grouped and
// updat_pallas (blocksparse_tpu/kernels/bsmm.py:1972, :593, :229), as
// bsmm_updat_mma.cu did before it; updat_kernel (kernels/bsmm.py) picks
// between the two by shape: this kernel but for groups that alone fill
// two waves of it over long runs (the N split then does not apply, and
// the mma.sync kernel's two thread blocks an SM hide latency better).
// The N split's second pass,
// bsmm_updat_reduce_nc, stays in bsmm_updat_mma.cu and reads this kernel's
// partials as it read that one's.
//
// Bound on the H100: at the LM's training shape (N = 16384, b32, 558
// blocks, 512 -> 2048) a call is 18.7 GFLOP (0.019 ms of bf16 tensor-core
// work) against 86 MB of inputs and outputs (0.0257 ms): bound by bytes.
// Over updat_plan's groups, P's tiles are read once per block and Q's once
// per group, N * B * 2 * (blocks + groups) bytes from L2 (0.66 GB there):
// bsmm_updat_mma.cu moves them with cp.async and ldmatrix, 16 bytes a
// thread, and multiplies on mma.sync.
//
// The design.  The host plan (updat_plan) cuts the layout's blocks into
// groups of up to G = 256 / B blocks that share one operand tile Q (an x
// block-row, or a dy block-column); P is the other operand, one tile a
// slot.  One thread block owns one (group, run of N) and computes
//   D (256 x B) = P_group^T . Q_tile,
// slot t's B rows being dw[e] (P = x) or dw[e]^T (P = dy, TRANS_OUT).  The
// contraction runs over the token rows, TN = 64 of them a ring stage: the
// long K loop wgmma is best at.  The N split (updat_splits) cuts N into
// runs of whole stages, its count the one that best fills the last wave of
// one thread block an SM.  A ring stage is G slot boxes of P (TN
// tokens x A = min(B, 64) columns; two a slot at b128) and Q's box(es),
// each one TMA load; slots past the group's last entry are not loaded and
// their rows of D not stored.  Both operands arrive token-major: P^T is an
// M-major A operand (a 64-row m tile spans 64 / A slot boxes, LBO apart)
// and Q an N-major B operand, both legal for 16-bit wgmma.  Two consumer
// warpgroups own two m64 tiles of D each (accumulators in registers); a
// producer warpgroup's first thread keeps the ring of STAGES slots full (a
// full and an empty mbarrier a slot; a slot goes back to the producer
// once the products of the stage after it are issued, so one stage's
// wgmma overlaps the next one's wait).  Token rows past N arrive as zeros
// (TMA's out-of-bounds fill); the runs of a split are multiples of TN rows
// (updat_run_rows), so a stage never reaches into the next run.
//
// Order: each output is summed stage by stage, k16 step by k16 step, in
// f32, then (split) run by run by the reduce: no atomics, two runs give
// identical bits.  bf16 x bf16 and f16 x f16 products are exact in f32;
// only the order of the sum differs from the plain version.
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int TN = 64;                    // token rows a ring stage
constexpr int MROWS = 256;                // rows of D: G slots of B columns
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int RING = 192 * 1024;          // at most this many bytes of stages

template <int B> struct Cfg {
  static constexpr int A = B < 64 ? B : 64;  // a box's columns (one swizzle row)
  static constexpr int SB = B / A;           // boxes a slot (and Q)
  static constexpr int G = MROWS / B;        // slots
  static constexpr int BOX = TN * A * 2;     // bytes of a box
  static constexpr int STAGE = (G + 1) * SB * BOX;
  static constexpr int STAGES = RING / STAGE;
  static constexpr int MBOX = 64 / A;        // boxes an m64 tile spans
  static_assert(STAGES >= 2 && BOX % 1024 == 0, "ring stages");
};

template <int B>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(Cfg<B>::STAGES) * Cfg<B>::STAGE +
         2 * Cfg<B>::STAGES * sizeof(uint64_t);
}

// p (N, ldp) through pmap, q (N, ldq) through qmap; group g: Q block
// grp_q[g], slots slot_p[g*G + t] (P block, -1 past the group's last
// entry) writing block slot_e[g*G + t].  Thread block (g, s) sums rows
// [s*rows, min(N, (s+1)*rows)) into out[s] (blocks, B, B).
template <typename T, int B, bool TRANS_OUT>
__global__ void __launch_bounds__(THREADS, 1)
bsmm_updat_wgmma_kernel(const __grid_constant__ CUtensorMap pmap,
                        const __grid_constant__ CUtensorMap qmap, const int* __restrict__ grp_q,
                        const int* __restrict__ slot_p, const int* __restrict__ slot_e,
                        float* __restrict__ out, int N, int groups, int rows, int blocks) {
  using S = Cfg<B>;
  constexpr int A = S::A, SB = S::SB, G = S::G, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  // the groups of one run run fastest: that run's x and dy rows come from
  // device memory about once
  const int grp = blockIdx.x % groups, run = blockIdx.x / groups;
  const int n_begin = run * rows;
  const int n_end = min(N, n_begin + rows);
  const int stages = n_end > n_begin ? (n_end - n_begin + TN - 1) / TN : 0;
  const int* sp = slot_p + static_cast<size_t>(grp) * G;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      // the slots' P columns, read once (slots fill from 0; -1 past the last)
      int pcol[G];
      int live = 0;
#pragma unroll
      for (int t = 0; t < G; ++t) {
        const int pb = __ldg(sp + t);
        pcol[t] = pb * B;
        live += pb >= 0;
      }
      const int qcol = __ldg(grp_q + grp) * B;
      for (int s = 0; s < stages; ++s) {
        const int slot = s % STAGES;
        mbar_wait(empty + slot, ((s / STAGES) & 1) ^ 1);
        unsigned char* st = ring + slot * S::STAGE;
        const int n0 = n_begin + s * TN;
        mbar_expect_tx(full + slot, (live + 1) * SB * S::BOX);
#pragma unroll
        for (int t = 0; t < G; ++t)
          if (t < live)
#pragma unroll
            for (int h = 0; h < SB; ++h)
              tma_load_2d(st + (t * SB + h) * S::BOX, &pmap, full + slot, pcol[t] + h * A, n0);
#pragma unroll
        for (int h = 0; h < SB; ++h)
          tma_load_2d(st + (G * SB + h) * S::BOX, &qmap, full + slot, qcol + h * A, n0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns m64 tiles 2 wg and 2 wg + 1 of D ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
    // an m64 tile whose first slot is empty holds no block: not stored
    bool live[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) live[m] = __ldg(sp + (2 * wg + m) * S::MBOX / SB) >= 0;
    float acc[2][SB][A / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < SB; ++h)
#pragma unroll
        for (int r = 0; r < A / 2; ++r) acc[m][h][r] = 0.f;

    for (int s = 0; s < stages; ++s) {
      const int slot = s % STAGES;
      mbar_wait(full + slot, (s / STAGES) & 1);
      const uint32_t base = smem_addr(ring + slot * S::STAGE);
      const uint32_t qa = base + G * SB * S::BOX;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TN / 16; ++ks) {
        // k16 step ks: 16 token rows of each (MN-major) box
        // an m64 tile of empty slots multiplies what their boxes last held:
        // its rows of D are never stored (a branch here would make ptxas
        // serialize the products)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint64_t da = sw_desc<2 * A>(
              base + (2 * wg + m) * S::MBOX * S::BOX + ks * 32 * A, S::BOX, 16 * A);
#pragma unroll
          for (int h = 0; h < SB; ++h) {
            const uint64_t db = sw_desc<2 * A>(qa + h * S::BOX + ks * 32 * A, 16 * A, 16 * A);
            wgmma<1, 1>(acc[m][h], da, db, 1, T());
          }
        }
      }
      wgmma_commit();
      // the products of the stage before are done: the producer may refill
      // its slot (this stage's stay in flight)
      wgmma_wait<1>();
      __syncwarp();
      if (s > 0 && lane == 0) mbar_arrive(empty + (s + STAGES - 1) % STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < SB; ++h) fence_regs(acc[m][h]);

    // epilogue: each slot's rows of D straight from the registers (an
    // 8-row by 8-column piece of a tile fills whole 32-byte sectors either
    // way)
    float* o = out + static_cast<size_t>(run) * blocks * B * B;
    const int tg = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (!live[m]) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = (2 * wg + m) * 64 + (warp & 3) * 16 + hh * 8 + (lane >> 2);
        const int e = __ldg(slot_e + static_cast<size_t>(grp) * G + row / B);
        if (e < 0) continue;
        const int r = row % B;
        float* ob = o + static_cast<size_t>(e) * B * B;
#pragma unroll
        for (int h = 0; h < SB; ++h)
#pragma unroll
          for (int jn = 0; jn < A / 8; ++jn) {
            const int c = h * A + jn * 8 + tg * 2;
            const float v0 = acc[m][h][4 * jn + 2 * hh], v1 = acc[m][h][4 * jn + 2 * hh + 1];
            if constexpr (TRANS_OUT) {  // D holds dw[e]^T
              ob[c * B + r] = v0;
              ob[(c + 1) * B + r] = v1;
            } else {
              *reinterpret_cast<float2*>(ob + r * B + c) = make_float2(v0, v1);
            }
          }
      }
    }
  }
}

template <typename T, int B, bool TRANS_OUT>
cudaError_t launch(const void* p, const void* q, const int* grp_q, const int* slot_p,
                   const int* slot_e, float* out, int N, int ldp, int ldq, int groups, int splits,
                   int rows, int blocks, cudaStream_t stream) {
  using S = Cfg<B>;
  auto kernel = bsmm_updat_wgmma_kernel<T, B, TRANS_OUT>;
  constexpr size_t bytes = smem_bytes<B>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters)
  CUtensorMap pmap, qmap;
  const cuuint32_t box[2] = {S::A, TN};
  const cuuint64_t pdims[2] = {(cuuint64_t)ldp, (cuuint64_t)N};
  const cuuint64_t pstrides[1] = {(cuuint64_t)ldp * sizeof(T)};
  err = tiled_map<T>(&pmap, p, 2, pdims, pstrides, box, 2 * S::A);
  if (err != cudaSuccess) return err;
  const cuuint64_t qdims[2] = {(cuuint64_t)ldq, (cuuint64_t)N};
  const cuuint64_t qstrides[1] = {(cuuint64_t)ldq * sizeof(T)};
  err = tiled_map<T>(&qmap, q, 2, qdims, qstrides, box, 2 * S::A);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(groups) * static_cast<unsigned>(splits);
  kernel<<<grid, THREADS, bytes, stream>>>(pmap, qmap, grp_q, slot_p, slot_e, out, N, groups,
                                           rows, blocks);
  return cudaGetLastError();
}

#define UPDAT_ARGS p, q, grp_q, slot_p, slot_e, out, N, ldp, ldq, groups, splits, rows, blocks, s

template <typename T>
cudaError_t dispatch(int bsize, int trans_out, const void* p, const void* q, const int* grp_q,
                     const int* slot_p, const int* slot_e, float* out, int N, int ldp, int ldq,
                     int groups, int splits, int rows, int blocks, cudaStream_t s) {
  switch (bsize) {
    case 32:
      return trans_out ? launch<T, 32, true>(UPDAT_ARGS) : launch<T, 32, false>(UPDAT_ARGS);
    case 64:
      return trans_out ? launch<T, 64, true>(UPDAT_ARGS) : launch<T, 64, false>(UPDAT_ARGS);
    case 128:
      return trans_out ? launch<T, 128, true>(UPDAT_ARGS) : launch<T, 128, false>(UPDAT_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bsmm_updat_mma_nc's interface, block sizes 32, 64 and 128 (any other, or
// a dtype other than 1 = bfloat16 and 2 = float16, returns
// cudaErrorInvalidValue).  p (N, ldp) is the operand with one tile a slot,
// q (N, ldq) the one each group shares; trans_out = 1 when q is x.  grp_q
// (groups,), slot_p and slot_e (groups, 256 / bsize) int32: updat_plan's
// arrays.  out: f32 (splits, blocks, bsize, bsize), run s summing token
// rows [s*rows, (s+1)*rows) (rows a multiple of 64 when splits > 1).  p and
// q 16-byte aligned, ldp and ldq multiples of 8, N >= 1.  Returns a
// cudaError_t (0 = launched).
extern "C" int bsmm_updat_wgmma_nc(int dtype, int bsize, int trans_out, const void* p,
                                   const void* q, const int* grp_q, const int* slot_p,
                                   const int* slot_e, void* out, int N, int ldp, int ldq,
                                   int groups, int splits, int rows, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || groups < 1 || splits < 1) return cudaErrorInvalidValue;
  if (splits > 1 && rows % TN) return cudaErrorInvalidValue;
  float* outf = static_cast<float*>(out);
#define UPDAT_CALL(T) \
  dispatch<T>(bsize, trans_out, p, q, grp_q, slot_p, slot_e, outf, N, ldp, ldq, groups, splits, \
              rows, blocks, s)
  if (dtype == 1) return UPDAT_CALL(__nv_bfloat16);
  if (dtype == 2) return UPDAT_CALL(__half);
  return cudaErrorInvalidValue;
#undef UPDAT_CALL
}

#undef UPDAT_ARGS
