// Block-sparse matmul weight gradient (updat) for long, many-group
// products on Hopper: warpgroup tensor-core products (wgmma) fed by TMA,
// bf16 and f16, in the NC orientation:
//   dw[e] (B, B) = x[:, c_e*B:(c_e+1)*B]^T . dy[:, k_e*B:(k_e+1)*B],
// summed over the N token rows, for every layout block e, in f32.
// Block sizes 32 and 64 (b8 and b16 stay on bsmm_updat_mma.cu, b128 on
// bsmm_updat_wgmma.cu).
//
// Replaces, for bf16 and f16 inputs and canonical (blocks, B, B) weights,
// the TPU kernels updat_pallas_dense_tile, updat_pallas_grouped and
// updat_pallas (blocksparse_tpu/kernels/bsmm.py:1972, :593, :229) where
// the route rule (updat_kernel in kernels/bsmm.py) picks it: the conv's
// long-N products (N 32,768, im2col's X nine times as wide as dy), which
// bsmm_updat_mma.cu and bsmm_updat_wgmma.cu ran over updat_plan's groups.
// The N split's second pass, bsmm_updat_reduce_nc, stays in
// bsmm_updat_mma.cu and reads this kernel's partials as it reads theirs.
//
// Bound on the H100: the conv at C=2048 (d 0.25, 9,783 blocks of 32,
// N 32,768) is 656 GFLOP, 0.66 ms of bf16 tensor-core work, against
// 1.38 GB of inputs and outputs (0.41 ms): bound by operations.  Over
// updat_plan's groups a call reads N * B * 2 * (blocks + groups) bytes,
// 23.1 GB there: dy's column shared by a group, every slot a block-row of
// X, each X tile read once a block (~17 times) by thread blocks at
// different token rows, so from device memory (the HBM's rate in
// PERF.md).
//
// The design.  The host plan (updat_sparse_plan) takes the wider operand
// as Q, the one a group shares (X at the conv), and the narrower one as P,
// one tile a slot (dy), and bundles R of Q's block-rows that name the same
// P blocks (the conv's taps of one input block; R = 3 at the conv's three
// widths): a group is up to G = 256 / B slots of the union of a bundle's
// P blocks, so a slot's P tile, staged once, serves all R of the bundle's
// Q tiles.  At C=2048 that reads 4,719 tiles a token row against 11,034
// over updat_plan (9.9 GB against 23.1).  One thread block computes a
// group's
//   D (256 x R*B) = P_slots^T . [Q_1 .. Q_R]
// over its token rows, TN = 64 a ring stage, one m64n(R*B)k16 product an
// m64 tile and k16 step (the n96 at R = 3 reads A from shared memory once
// for three Q tiles).  D's row t*B + r, column j*B + c is dw[e][c][r] of
// the block e = slot_e[t][j] (P = dy: TRANS_OUT) or dw[e][r][c] (P = x);
// a (slot, Q tile) without a block is computed and not stored.  A ring
// stage holds the group's live slot boxes and Q boxes (TN tokens x B
// columns, each one TMA load, in the 64- or 128-byte swizzle); slots and
// Q tiles past the group's last are not loaded, what their smem held is
// multiplied into D's rows and columns that are never stored.  Both
// operands arrive token-major: P^T is an M-major A operand (an m64 tile
// spans 64 / B slot boxes), [Q_1 .. Q_R] an N-major B operand spanning R
// boxes, both BOX apart.  Two consumer warpgroups own two m64 tiles of D
// each (accumulators in registers); the producer warpgroup's first thread
// keeps the ring full (a full and an empty mbarrier a slot; a slot goes
// back once the stage after it has issued its products).
//
// The L2 window.  The thread blocks are persistent, one an SM, and walk
// the items (group, run of the N split) b, b + grid, ... in the plan's
// order: the items in flight are grid consecutive groups (a bundle's
// groups among them, reading its Q tiles from L2 once), and each walks
// its run's token rows from the first, so the resident thread blocks move
// through one window of token rows together and a P tile read by one
// comes from L2 for the others (dy at C=2048, 4 KB a token row, spans
// 12,000 rows of the 50 MB L2).  Nothing holds them together but equal
// work: the plan's groups of a bundle differ by one slot at most, and a
// group's stage costs its live slots + R boxes (5-8 + 3 at C=2048).
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

template <int B, int R> struct Cfg {
  static_assert(B == 32 || B == 64, "block sizes 32 and 64");
  static constexpr int G = MROWS / B;        // slots
  static constexpr int NQ = R * B;           // D's columns: R Q tiles
  static constexpr int BOX = TN * B * 2;     // bytes of a box (one swizzle row a token)
  static constexpr int STAGE = (G + R) * BOX;
  static constexpr int STAGES = RING / STAGE;
  static constexpr int MBOX = 64 / B;        // slot boxes an m64 tile spans
  static_assert(STAGES >= 2 && BOX % 1024 == 0 && NQ <= 128, "ring stages");
};

template <int B, int R>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(Cfg<B, R>::STAGES) * Cfg<B, R>::STAGE +
         2 * Cfg<B, R>::STAGES * sizeof(uint64_t);
}

// p (N, ldp) through pmap, q (N, ldq) through qmap; group g: Q blocks
// grp_q[g*R + j] (-1 past the bundle's last), slots slot_p[g*G + t] (P
// block, -1 past the group's last), block slot_e[(g*G + t)*R + j] (-1:
// none).  Item i (< items = groups * runs) is group i % groups over rows
// [run*rows, min(N, (run+1)*rows)), run = i / groups, summed into
// out[run] (blocks, B, B); thread block b takes items b, b + grid, ...
template <typename T, int B, int R, bool TRANS_OUT>
__global__ void __launch_bounds__(THREADS, 1)
bsmm_updat_sparse_kernel(const __grid_constant__ CUtensorMap pmap,
                         const __grid_constant__ CUtensorMap qmap, const int* __restrict__ grp_q,
                         const int* __restrict__ slot_p, const int* __restrict__ slot_e,
                         float* __restrict__ out, int N, int groups, int items, int rows,
                         int blocks) {
  using S = Cfg<B, R>;
  constexpr int G = S::G, STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full, item after item ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      int it = 0;  // ring stages so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int grp = item % groups, n_begin = (item / groups) * rows;
        const int stages = (min(N, n_begin + rows) - n_begin + TN - 1) / TN;
        // the slots' and Q tiles' columns (both fill from 0; -1 past the last)
        int pcol[G], qcol[R];
        int live = 0, qlive = 0;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int pb = __ldg(slot_p + static_cast<size_t>(grp) * G + t);
          pcol[t] = pb * B;
          live += pb >= 0;
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qb = __ldg(grp_q + static_cast<size_t>(grp) * R + j);
          qcol[j] = qb * B;
          qlive += qb >= 0;
        }
        for (int s = 0; s < stages; ++s, ++it) {
          const int slot = it % STAGES;
          mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + slot * S::STAGE;
          const int n0 = n_begin + s * TN;
          mbar_expect_tx(full + slot, (live + qlive) * S::BOX);
#pragma unroll
          for (int t = 0; t < G; ++t)
            if (t < live) tma_load_2d(st + t * S::BOX, &pmap, full + slot, pcol[t], n0);
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (j < qlive) tma_load_2d(st + (G + j) * S::BOX, &qmap, full + slot, qcol[j], n0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns m64 tiles 2 wg and 2 wg + 1 of D ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31, tg = lane & 3;
    float acc[2][S::NQ / 2];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int grp = item % groups, run = item / groups, n_begin = run * rows;
      const int stages = (min(N, n_begin + rows) - n_begin + TN - 1) / TN;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < S::NQ / 2; ++r) acc[m][r] = 0.f;

      for (int s = 0; s < stages; ++s, ++it) {
        const int slot = it % STAGES;
        mbar_wait(full + slot, (it / STAGES) & 1);
        const uint32_t base = smem_addr(ring + slot * S::STAGE);
        const uint32_t qa = base + G * S::BOX;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TN / 16; ++ks) {
          // k16 step ks: 16 token rows of each (MN-major) box; an m64 tile
          // of empty slots multiplies what their boxes last held: its rows
          // of D are never stored (a branch here would make ptxas
          // serialize the products)
          const uint64_t db = sw_desc<2 * B>(qa + ks * 32 * B, S::BOX, 16 * B);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint64_t da =
                sw_desc<2 * B>(base + (2 * wg + m) * S::MBOX * S::BOX + ks * 32 * B, S::BOX, 16 * B);
            wgmma<1, 1>(acc[m], da, db, 1, T());
          }
        }
        wgmma_commit();
        // the products of the stage before are done: the producer may
        // refill its slot (this stage's stay in flight)
        wgmma_wait<1>();
        __syncwarp();
        if (s > 0 && lane == 0) mbar_arrive(empty + (it + STAGES - 1) % STAGES);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
      // the item's last stage is done too
      __syncwarp();
      if (stages > 0 && lane == 0) mbar_arrive(empty + (it + STAGES - 1) % STAGES);

      // epilogue: each (slot, Q tile) block's piece of D straight from the
      // registers (an 8-row by 8-column piece fills whole 32-byte sectors
      // either way) while the producer fills the ring for the next item
      float* o = out + static_cast<size_t>(run) * blocks * B * B;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = (2 * wg + m) * 64 + (warp & 3) * 16 + hh * 8 + (lane >> 2);
          const int r = row % B;
          const int* se = slot_e + (static_cast<size_t>(grp) * G + row / B) * R;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int e = __ldg(se + j);
            if (e < 0) continue;
            float* ob = o + static_cast<size_t>(e) * B * B;
#pragma unroll
            for (int jn = 0; jn < B / 8; ++jn) {
              const int c = jn * 8 + tg * 2;
              const int i = 4 * (j * (B / 8) + jn) + 2 * hh;
              if constexpr (TRANS_OUT) {  // D holds dw[e]^T
                ob[c * B + r] = acc[m][i];
                ob[(c + 1) * B + r] = acc[m][i + 1];
              } else {
                *reinterpret_cast<float2*>(ob + r * B + c) = make_float2(acc[m][i], acc[m][i + 1]);
              }
            }
          }
        }
    }
  }
}

template <typename T, int B, int R, bool TRANS_OUT>
cudaError_t launch(const void* p, const void* q, const int* grp_q, const int* slot_p,
                   const int* slot_e, float* out, int N, int ldp, int ldq, int groups, int splits,
                   int rows, int blocks, cudaStream_t stream) {
  auto kernel = bsmm_updat_sparse_kernel<T, B, R, TRANS_OUT>;
  constexpr size_t bytes = smem_bytes<B, R>();
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters)
  CUtensorMap pmap, qmap;
  const cuuint32_t box[2] = {B, TN};
  const cuuint64_t pdims[2] = {(cuuint64_t)ldp, (cuuint64_t)N};
  const cuuint64_t pstrides[1] = {(cuuint64_t)ldp * sizeof(T)};
  err = tiled_map<T>(&pmap, p, 2, pdims, pstrides, box, 2 * B);
  if (err != cudaSuccess) return err;
  const cuuint64_t qdims[2] = {(cuuint64_t)ldq, (cuuint64_t)N};
  const cuuint64_t qstrides[1] = {(cuuint64_t)ldq * sizeof(T)};
  err = tiled_map<T>(&qmap, q, 2, qdims, qstrides, box, 2 * B);
  if (err != cudaSuccess) return err;
  const int items = groups * splits;
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  kernel<<<grid, THREADS, bytes, stream>>>(pmap, qmap, grp_q, slot_p, slot_e, out, N, groups,
                                           items, rows, blocks);
  return cudaGetLastError();
}

#define UPDAT_ARGS p, q, grp_q, slot_p, slot_e, out, N, ldp, ldq, groups, splits, rows, blocks, s

template <typename T, int B, int R>
cudaError_t launch_t(int trans_out, const void* p, const void* q, const int* grp_q,
                     const int* slot_p, const int* slot_e, float* out, int N, int ldp, int ldq,
                     int groups, int splits, int rows, int blocks, cudaStream_t s) {
  return trans_out ? launch<T, B, R, true>(UPDAT_ARGS) : launch<T, B, R, false>(UPDAT_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int bundle, int trans_out, const void* p, const void* q,
                     const int* grp_q, const int* slot_p, const int* slot_e, float* out, int N,
                     int ldp, int ldq, int groups, int splits, int rows, int blocks,
                     cudaStream_t s) {
  switch (bsize * 8 + bundle) {
    case 32 * 8 + 1: return launch_t<T, 32, 1>(trans_out, UPDAT_ARGS);
    case 32 * 8 + 2: return launch_t<T, 32, 2>(trans_out, UPDAT_ARGS);
    case 32 * 8 + 3: return launch_t<T, 32, 3>(trans_out, UPDAT_ARGS);
    case 32 * 8 + 4: return launch_t<T, 32, 4>(trans_out, UPDAT_ARGS);
    case 64 * 8 + 1: return launch_t<T, 64, 1>(trans_out, UPDAT_ARGS);
    case 64 * 8 + 2: return launch_t<T, 64, 2>(trans_out, UPDAT_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Block sizes 32 (bundles of R = 1-4) and 64 (R = 1, 2); any other, or a
// dtype other than 1 = bfloat16 and 2 = float16, returns
// cudaErrorInvalidValue.  p (N, ldp) is the operand with one tile a slot,
// q (N, ldq) the one a group shares; trans_out = 1 when q is x.  grp_q
// (groups, R), slot_p (groups, 256 / bsize) and slot_e (groups, 256 /
// bsize, R) int32: updat_sparse_plan's arrays.  out: f32 (splits, blocks,
// bsize, bsize), run s summing token rows [s*rows, (s+1)*rows) (rows a
// multiple of 64 when splits > 1).  p and q 16-byte aligned, ldp and ldq
// multiples of 8, N >= 1.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_updat_sparse_nc(int dtype, int bsize, int bundle, int trans_out,
                                    const void* p, const void* q, const int* grp_q,
                                    const int* slot_p, const int* slot_e, void* out, int N,
                                    int ldp, int ldq, int groups, int splits, int rows,
                                    int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || groups < 1 || splits < 1) return cudaErrorInvalidValue;
  if (splits > 1 && rows % TN) return cudaErrorInvalidValue;
  float* outf = static_cast<float*>(out);
#define UPDAT_CALL(T) \
  dispatch<T>(bsize, bundle, trans_out, p, q, grp_q, slot_p, slot_e, outf, N, ldp, ldq, groups, \
              splits, rows, blocks, s)
  if (dtype == 1) return UPDAT_CALL(__nv_bfloat16);
  if (dtype == 2) return UPDAT_CALL(__half);
  return cudaErrorInvalidValue;
#undef UPDAT_CALL
}

#undef UPDAT_ARGS
