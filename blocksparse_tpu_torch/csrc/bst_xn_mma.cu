// The unfused block-sparse attention's sparse x dense products on Hopper's
// tensor cores, bf16 and f16 (nn_op and tn_op of BlocksparseTransformer,
// and the gradients of all three ops):
//   NN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]   . x_blk(ent_x[e]),
//   TN  y[r] = sum over row r's entries e of w[n, h, ent_w[e]]^T . x_blk(ent_x[e]),
// each output block-row r a (B x hs) tile of y (batch, rows*B, heads*hs),
// summed in f32 in a fixed order and rounded once; a row with no entries
// is zeros.  NN walks the query-row CSR (weights in row order, x = v at
// the key blocks), TN the key-row CSR (x = q or dy at the query blocks).
// x is read in place through its batch and row strides.
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) in its _xn_impl_pallas use
// (blocksparse_tpu/ops/transformer.py), vmapped there over batch*heads with
// the per-instance weight panels of dense_tile_panels (transposed cells for
// TN).  f32 inputs run bst_xn.cu, exact on the CUDA cores.
//
// Bound on the H100: at the LM's check shape (batch 8, ctx 2048, B 64, 312
// blocks, 2 heads of 256) a call reads the 40.9 MB of scores and x (16.8
// MB) and writes y (16.8 MB): 74.4 MB, 22 us at 3.35 TB/s, against 10.5
// GFLOP, 11 us of bf16 tensor-core work: bound by bytes.  Beyond that,
// each entry reads its x block (B x hs), and its score block once a column
// group, from L2: 245 MB through L2 at the check shape (two groups of
// 128), the design's floor.
//
// Design: as the TPU kernel takes the whole head as one lane tile, a
// thread block owns an output row's whole head up to 128 columns, and past
// that column groups of CW = 128 (CW = 64 up to hs 64): each score block
// is read once a group, twice at hs 256.  (A 256-column group would read
// it once, but its block holds 160 KB of ring, so one block fits an SM
// against two of 128 columns; it runs slower at hs 256.)
//
// Block size 64 (bst_xn_wg_kernel) runs on wgmma: one warpgroup at CW 64,
// two at CW 128, each owning 64 of the group's columns (a 64 x 64 f32
// tile, 32 accumulators a thread).  A stage is
// one entry: its weight block and its x block's rows, read by TMA boxes
// of 64 x 64 as they lie in memory into wgmma's 128-byte swizzled layout
// (x's columns past hs arrive as zeros); A is the weight block, read
// K-major for NN ([i][l]) and MN-major for TN ([l][i]: transposed by the
// tensor cores, not by a copy), B the x rows, MN-major ([l][c]).  A
// four-slot ring, an mbarrier a slot, keeps two stages in flight while
// one is multiplied and the one before may still be read by the other
// warpgroup's last product; one thread issues the copies.
//
// Block sizes 8-32 (bst_xn_mma_kernel) run on mma.sync m16n8k16: eight
// warps (four at CW 64 and B <= 16), b8 rows padded to one m16.  The row's
// entries go in stages of KD = 32 contraction rows, E = 32 / B entries:
// their weight blocks side by side as one (B x 32) A tile, kept as stored
// for NN ([i][l]) and for TN ([l][i], read transposed by ldmatrix.trans);
// their x blocks stacked as one (32 x CW) tile read by ldmatrix.trans.
// Copies are 16-byte cp.async, zero-filled past the row's last entry and
// past hs, in a four-slot ring (three stages in flight).
//
// The launch plan (trio_tables' plan / plan_t: the CSR's row pointers,
// then each layout head's items in pairs, rows longest first) gives each
// cluster of two thread blocks a pair of items (row*4 + part; -1 none):
// two whole rows, each on its own block, or the two halves of a row far
// longer than the mean (part 1 its first ceil(count/2) entries, part 2
// the rest).  A split row's second block leaves its f32 sums in its shared
// memory; after a cluster barrier the first adds them to its own through
// distributed shared memory (first half + second half) and a second
// barrier keeps them alive until read.  The finished tile is rounded once
// into shared memory and y written in 16-byte runs.  No atomics: each
// output is one chain of k16 steps in entry order (and one add of the two
// halves), so two runs give equal bits.
#include <cooperative_groups.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int STAGES = 4;
constexpr int KD = 32;  // contraction rows a stage

template <int B, bool TRANS, int CW> struct XnShape {
  static_assert(B <= KD, "block size 64 runs bst_xn_wg_kernel");
  static constexpr int MP = B < 16 ? 16 : B;  // output rows (b8: one m16)
  static constexpr int WM = MP / 16;          // warps along the rows, 16 rows each
  static constexpr int WN = 8 / WM < CW / 16 ? 8 / WM : CW / 16;  // along the columns
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int NT = CW / WN / 8;      // a warp's n8 tiles
  static constexpr int E = KD / B;            // entries a stage
  // A tile: NN [m][k] (MP rows of KD + 8); TN [k][m] (KD rows of MP + 8)
  static constexpr int ALD = TRANS ? MP + 8 : KD + 8;
  static constexpr int A_ELEMS = TRANS ? KD * ALD : MP * ALD;
  static constexpr int XLD = CW + 8;
  static constexpr int ELEMS = A_ELEMS + KD * XLD;  // a ring slot
  static constexpr int OLD = CW + 8;                // output staging row stride
};

template <typename T, int B, bool TRANS, int CW>
constexpr size_t smem_bytes() {
  using S = XnShape<B, TRANS, CW>;
  const size_t ring = STAGES * S::ELEMS * sizeof(T);
  const size_t out = S::MP * S::OLD * sizeof(T);
  const size_t sums = static_cast<size_t>(S::THREADS) * S::NT * sizeof(float4);
  return ring > out ? (ring > sums ? ring : sums) : (out > sums ? out : sums);
}

template <typename T, int B, bool TRANS, int CW>
__global__ void __launch_bounds__(XnShape<B, TRANS, CW>::THREADS, 2)
bst_xn_mma_kernel(const T* __restrict__ w, const T* __restrict__ x, T* __restrict__ y,
                  long long sx_b, long long sx_r, const int* __restrict__ plan,
                  const int* __restrict__ ent_w, const int* __restrict__ ent_x, int hs,
                  int heads, int lut_heads, int rows, int blocks, int items) {
  using S = XnShape<B, TRANS, CW>;
  static_assert(S::NT % 2 == 0, "n8 tiles are loaded in pairs");
  constexpr int THREADS = S::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % S::WM, wn = warp / S::WM;
  // clusters of two along x: rank = blockIdx.x & 1; batch*heads next, so
  // every instance's longest pairs start first; column groups last
  const int rank = blockIdx.x & 1, nh = blockIdx.x >> 1, c0 = blockIdx.z * CW;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int* rp = plan + lh * (rows + 1);
  const int item = plan[lut_heads * (rows + 1) + lh * items + 2 * blockIdx.y + rank];
  if (item < 0) return;
  const int r = item >> 2, part = item & 3;
  int eb = rp[r], ee = rp[r + 1];
  const int mid = eb + (ee - eb + 1) / 2;
  if (part == 1) ee = mid;
  if (part == 2) eb = mid;
  const int cnt = ee - eb;
  const int* ew = ent_w + static_cast<size_t>(lh) * blocks + eb;
  const int* ex = ent_x + static_cast<size_t>(lh) * blocks + eb;
  const T* wbase = w + static_cast<size_t>(nh) * blocks * B * B;
  const T* xbase = x + n * sx_b + static_cast<size_t>(h) * hs + c0;
  const int stages = (cnt + S::E - 1) / S::E;

  // the pad rows (NN) or columns (TN) of a b8 A tile are never loaded: zero
  // them once in every slot
  if constexpr (B < 16) {
    unsigned short* bits = reinterpret_cast<unsigned short*>(ring);
    for (int i = tid; i < STAGES * S::A_ELEMS; i += THREADS)
      bits[i / S::A_ELEMS * S::ELEMS + i % S::A_ELEMS] = 0;
    __syncthreads();
  }

  // stage s: the KD contraction rows of entries es .. es + E - 1 (row rho
  // of the stage: entry es + rho / B, its block row rho % B)
  auto load = [&](int s, int slot) {
    T* as = ring + slot * S::ELEMS;
    T* xs = as + S::A_ELEMS;
    const int es = s * S::E;
    if constexpr (TRANS) {
      // as[rho][i] = w[e][l][i]: B / 8 chunks a row
      constexpr int BCH = B / 8;
      for (int c = tid; c < KD * BCH; c += THREADS) {
        const int rho = c / BCH, cc = c % BCH, e = es + rho / B;
        const bool v = e < cnt;
        const T* src =
            v ? wbase + (static_cast<size_t>(__ldg(ew + e)) * B + rho % B) * B + cc * 8 : w;
        cp_async16(smem_addr(as + rho * S::ALD + cc * 8), src, v);
      }
    } else {
      // as[i][rho] = w[e][i][l]: KD / 8 chunks a row i < B
      constexpr int KCH = KD / 8;
      for (int c = tid; c < B * KCH; c += THREADS) {
        const int i = c / KCH, rho = c % KCH * 8, e = es + rho / B;
        const bool v = e < cnt;
        const T* src = v ? wbase + (static_cast<size_t>(__ldg(ew + e)) * B + i) * B + rho % B : w;
        cp_async16(smem_addr(as + i * S::ALD + rho), src, v);
      }
    }
    // the x blocks' rows, stacked: KD rows of CW columns
    constexpr int XCH = CW / 8;
    for (int c = tid; c < KD * XCH; c += THREADS) {
      const int rho = c / XCH, cc = c % XCH, e = es + rho / B;
      const bool v = e < cnt && c0 + cc * 8 < hs;
      const T* src = x;
      if (v) src = xbase + (static_cast<size_t>(__ldg(ex + e)) * B + rho % B) * sx_r + cc * 8;
      cp_async16(smem_addr(xs + rho * S::XLD + cc * 8), src, v);
    }
  };

  float acc[S::NT][4];
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const int m0 = wm * 16, nbase = wn * S::NT * 8;
  // a warp whose columns all lie past hs skips its products
  const bool live = c0 + nbase < hs;
  auto compute = [&](int slot) {
    const T* as = ring + slot * S::ELEMS;
    const T* xs = as + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 16) {
      uint32_t af[4];
      if constexpr (TRANS) {
        // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        // of A = as^T: smem rows are k, read transposed
        ldsm_x4_t(af, smem_addr(as + (kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * S::ALD + m0 +
                                ((lane >> 3) & 1) * 8));
      } else {
        ldsm_x4(af, smem_addr(as + (m0 + (lane & 15)) * S::ALD + kk + (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < S::NT; np += 2) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t rr[4];
        ldsm_x4_t(rr, smem_addr(xs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::XLD + nbase +
                                np * 8 + (lane >> 4) * 8));
        const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
        mma(acc[np], af, b0, T());
        mma(acc[np + 1], af, b1, T());
      }
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
  __syncthreads();  // the ring is free: the epilogue reuses its memory

  if (part != 0) {
    // a split row: the second half's block leaves its f32 sums in its
    // shared memory (thread-major float4s); the first adds them to its own
    // through distributed shared memory.  Both blocks of the cluster hold
    // the two halves of one row, so both reach both barriers.
    cg::cluster_group cluster = cg::this_cluster();
    float4* sums = reinterpret_cast<float4*>(smem);
    if (part == 2) {
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
        sums[nt * THREADS + tid] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
    cluster.sync();
    if (part == 1) {
      const float4* peer = cluster.map_shared_rank(sums, rank ^ 1);
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const float4 t = peer[nt * THREADS + tid];
        acc[nt][0] += t.x, acc[nt][1] += t.y, acc[nt][2] += t.z, acc[nt][3] += t.w;
      }
    }
    cluster.sync();  // the second half's sums stay alive until read
    if (part == 2) return;
  }

  // y's rows r*B + i of this group's columns c0 + col: rounded once into
  // shared memory, then written in 16-byte runs
  T* os = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt) {
    const int i0 = m0 + g, col = nbase + nt * 8 + tg * 2;
    store2(os + i0 * S::OLD + col, acc[nt][0], acc[nt][1]);
    store2(os + (i0 + 8) * S::OLD + col, acc[nt][2], acc[nt][3]);
  }
  __syncthreads();
  const size_t ld_y = static_cast<size_t>(heads) * hs;
  T* ybase = y + (static_cast<size_t>(n) * rows + r) * B * ld_y + static_cast<size_t>(h) * hs + c0;
  constexpr int XCH = CW / 8;
  for (int c = tid; c < B * XCH; c += THREADS) {
    const int i = c / XCH, cc = c % XCH;
    if (c0 + cc * 8 < hs)
      *reinterpret_cast<uint4*>(ybase + i * ld_y + cc * 8) =
          *reinterpret_cast<const uint4*>(os + i * S::OLD + cc * 8);
  }
}


// ---- block size 64 on wgmma ----
// One thread block of ATOMS = CW / 64 warpgroups owns a row's column group
// of CW head columns, a warpgroup an atom of 64 columns.  A stage
// is one entry: its 64 x 64 weight block (8 KB) and its x block's 64 rows
// of CW columns (8 KB an atom), both stored as they lie in memory in the
// 128-byte swizzled layout.  D (the 64 x 64 product of an atom, f32 in
// registers) += A . B over the entry's 64 contraction rows in k16 steps:
// A the weight block, K-major for NN (w[i][l]) and MN-major for TN
// (w[l][i], read transposed); B the x rows, MN-major (x[l][c]).
template <bool TRANS, int CW> struct Wg64 {
  static constexpr int ATOMS = CW / 64;  // warpgroups
  static constexpr int THREADS = 128 * ATOMS;
  static constexpr int WBYTES = 64 * 128;           // the weight block
  static constexpr int STAGE = WBYTES + ATOMS * 64 * 128;
  static constexpr int STAGES = 4;
  static constexpr int OLD = CW + 8;                // output staging row stride
};

template <typename T, bool TRANS, int CW>
constexpr size_t wg_smem_bytes() {
  using S = Wg64<TRANS, CW>;
  // 1 KB to align the ring to 1024 bytes, the ring (the epilogue reuses
  // it), an mbarrier a slot
  return 1024 + static_cast<size_t>(S::STAGES) * S::STAGE + S::STAGES * sizeof(uint64_t);
}

template <typename T, bool TRANS, int CW>
__global__ void __launch_bounds__(Wg64<TRANS, CW>::THREADS)
bst_xn_wg_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                 T* __restrict__ y, const int* __restrict__ plan, const int* __restrict__ ent_w,
                 const int* __restrict__ ent_x, int hs, int heads, int lut_heads, int rows,
                 int blocks, int items) {
  using S = Wg64<TRANS, CW>;
  constexpr int B = 64, THREADS = S::THREADS, STAGES = S::STAGES;
  static_assert(S::OLD * B * sizeof(T) <= STAGES * S::STAGE, "staging fits the ring");
  static_assert(THREADS * 32 * sizeof(float) <= STAGES * S::STAGE, "sums fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int rank = blockIdx.x & 1, nh = blockIdx.x >> 1, c0 = blockIdx.z * CW;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int* rp = plan + lh * (rows + 1);
  const int item = plan[lut_heads * (rows + 1) + lh * items + 2 * blockIdx.y + rank];
  if (item < 0) return;
  const int r = item >> 2, part = item & 3;
  int eb = rp[r], ee = rp[r + 1];
  const int mid = eb + (ee - eb + 1) / 2;
  if (part == 1) ee = mid;
  if (part == 2) eb = mid;
  const int cnt = ee - eb;
  const int* ew = ent_w + static_cast<size_t>(lh) * blocks + eb;
  const int* ex = ent_x + static_cast<size_t>(lh) * blocks + eb;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);  // a slot each
  // the group's 64-column atoms that hold head columns (the rest are never
  // loaded nor multiplied)
  const int atoms = min(S::ATOMS, (hs - c0 + 63) / 64);

  // stage s (one thread): entry s's weight block and x rows, TMA boxes of
  // 64 x 64 (x's columns past hs arrive as zeros)
  auto load = [&](int s) {
    unsigned char* slot = ring + (s % STAGES) * S::STAGE;
    uint64_t* bar = full + s % STAGES;
    mbar_expect_tx(bar, S::WBYTES + atoms * B * 128);
    tma_load_2d(slot, &wmap, bar, 0, (nh * blocks + __ldg(ew + s)) * B);
    const int xr = __ldg(ex + s) * B;
    for (int a = 0; a < atoms; ++a)
      tma_load_4d(slot + S::WBYTES + a * B * 128, &xmap, bar, c0 + a * 64, h, xr, n);
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // a warpgroup whose columns all lie past hs skips its products
  const bool live = wg < atoms;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES - 2 && s < cnt; ++s) load(s);
  for (int s = 0; s < cnt; ++s) {
    // every warpgroup's products of stage s - 2 are done (each waited for
    // all but its last group before this barrier): its slot takes stage s +
    // STAGES - 2
    __syncthreads();
    if (tid == 0 && s + STAGES - 2 < cnt) load(s + STAGES - 2);
    mbar_wait(full + s % STAGES, s / STAGES & 1);
    if (live) {
      const uint32_t base = smem_addr(ring + (s % STAGES) * S::STAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < B / 16; ++kk) {
        // k16 step kk: 32 bytes along a K-major row, 16 rows of an MN-major tile
        const uint64_t da = TRANS ? sw128_desc(base + kk * 2048, true)
                                  : sw128_desc(base + kk * 32, false);
        wgmma<TRANS ? 1 : 0, 1>(
            acc, da, sw128_desc(base + S::WBYTES + wg * B * 128 + kk * 2048, true), 1, T());
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // the ring is free: the epilogue reuses its memory

  if (part != 0) {
    // a split row: as in bst_xn_mma_kernel, the second half's f32 sums go
    // to the first through distributed shared memory
    cg::cluster_group cluster = cg::this_cluster();
    float4* sums = reinterpret_cast<float4*>(ring);
    if (part == 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sums[j * THREADS + tid] =
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster.sync();
    if (part == 1) {
      const float4* peer = cluster.map_shared_rank(sums, rank ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 t = peer[j * THREADS + tid];
        acc[4 * j] += t.x, acc[4 * j + 1] += t.y, acc[4 * j + 2] += t.z, acc[4 * j + 3] += t.w;
      }
    }
    cluster.sync();  // the second half's sums stay alive until read
    if (part == 2) return;
  }

  // y's rows r*64 + i of this group's columns c0 + col: rounded once into
  // shared memory, then written in 16-byte runs
  T* os = reinterpret_cast<T*>(ring);
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i0 = wq * 16 + g, col = wg * 64 + j * 8 + tg * 2;
    store2(os + i0 * S::OLD + col, acc[4 * j], acc[4 * j + 1]);
    store2(os + (i0 + 8) * S::OLD + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const size_t ld_y = static_cast<size_t>(heads) * hs;
  T* ybase = y + (static_cast<size_t>(n) * rows + r) * B * ld_y + static_cast<size_t>(h) * hs + c0;
  constexpr int XCH = CW / 8;
  for (int c = tid; c < B * XCH; c += THREADS) {
    const int i = c / XCH, cc = c % XCH;
    if (c0 + cc * 8 < hs)
      *reinterpret_cast<uint4*>(ybase + i * ld_y + cc * 8) =
          *reinterpret_cast<const uint4*>(os + i * S::OLD + cc * 8);
  }
}

// a cluster launch of two thread blocks a plan pair (cudaLaunchKernelEx,
// cluster dimension {2, 1, 1}); refuses once a cluster that could not be
// resident
template <typename Kernel, typename... Args>
cudaError_t launch_pairs(Kernel kernel, int threads, size_t bytes, unsigned& ready, bool& fits,
                         dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fits) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fits = true;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int B, bool TRANS, int CW>
cudaError_t launch_one(const void* w, const void* x, void* y, const long long* st,
                       const int* plan, const int* ent_w, const int* ent_x, int hs, int batch,
                       int heads, int lut_heads, int rows, int blocks, int items, int ctx_in,
                       cudaStream_t stream) {
  static unsigned ready = 0;
  static bool fits = false;
  // batch*heads (and the pair's rank) along x, so every instance's longest
  // pairs start first; column groups last
  const dim3 grid(2 * batch * heads, items / 2, (hs + CW - 1) / CW);
  T* yt = static_cast<T*>(y);
  if constexpr (B == 64) {
    // w's blocks and x's rows read by TMA boxes of 64 x 64
    CUtensorMap wmap, xmap;
    cudaError_t err = block_rows_map<T>(&wmap, w, 64LL * batch * heads * blocks);
    if (err != cudaSuccess) return err;
    err = head_rows_map<T>(&xmap, x, hs, heads, ctx_in, batch, st[1], st[0], 64);
    if (err != cudaSuccess) return err;
    return launch_pairs(bst_xn_wg_kernel<T, TRANS, CW>, Wg64<TRANS, CW>::THREADS,
                        wg_smem_bytes<T, TRANS, CW>(), ready, fits, grid, stream, wmap, xmap, yt,
                        plan, ent_w, ent_x, hs, heads, lut_heads, rows, blocks, items);
  } else {
    return launch_pairs(bst_xn_mma_kernel<T, B, TRANS, CW>, XnShape<B, TRANS, CW>::THREADS,
                        smem_bytes<T, B, TRANS, CW>(), ready, fits, grid, stream,
                        static_cast<const T*>(w), static_cast<const T*>(x), yt, st[0], st[1],
                        plan, ent_w, ent_x, hs, heads, lut_heads, rows, blocks, items);
  }
}

#define XN_ARGS \
  w, x, y, strides, plan, ent_w, ent_x, hs, batch, heads, lut_heads, rows, blocks, items, ctx_in, s

// the column group: the whole head up to 64 columns, else groups of 128
template <typename T, int B, bool TRANS>
cudaError_t launch_cw(const void* w, const void* x, void* y, const long long* strides,
                      const int* plan, const int* ent_w, const int* ent_x, int hs, int batch,
                      int heads, int lut_heads, int rows, int blocks, int items, int ctx_in,
                      cudaStream_t s) {
  if (hs <= 64) return launch_one<T, B, TRANS, 64>(XN_ARGS);
  return launch_one<T, B, TRANS, 128>(XN_ARGS);
}

template <typename T, int B>
cudaError_t launch(int trans, const void* w, const void* x, void* y, const long long* strides,
                   const int* plan, const int* ent_w, const int* ent_x, int hs, int batch,
                   int heads, int lut_heads, int rows, int blocks, int items, int ctx_in,
                   cudaStream_t s) {
  return trans ? launch_cw<T, B, true>(XN_ARGS) : launch_cw<T, B, false>(XN_ARGS);
}

template <typename T>
cudaError_t dispatch(int bsize, int trans, const void* w, const void* x, void* y,
                     const long long* strides, const int* plan, const int* ent_w,
                     const int* ent_x, int hs, int batch, int heads, int lut_heads, int rows,
                     int blocks, int items, int ctx_in, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(trans, XN_ARGS);
    case 16: return launch<T, 16>(trans, XN_ARGS);
    case 32: return launch<T, 32>(trans, XN_ARGS);
    case 64: return launch<T, 64>(trans, XN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (batch, rows * bsize, heads * hs) = NN (trans 0) or TN (trans 1) of the
// weights w (batch, heads, blocks, bsize, bsize) and x (batch, ctx_in,
// heads * hs) over a CSR and its launch plan: plan (lut_heads * (rows + 1
// + items)) = every layout head's row pointers, then every head's `items`
// plan items in pairs (trio_tables' plan or plan_t); ent_w, ent_x
// (lut_heads, blocks); x holds ctx_in rows.  bf16 (dtype 1) or f16 (dtype 2); any other dtype,
// block size, a head size that is not a multiple of 8, or an odd item
// count (or past 2 * 65535) returns cudaErrorInvalidValue.  strides: x's
// batch and row strides in elements; w, x 16-byte aligned, x's strides
// multiples of 8 (at block size 64 TMA reads them).  Returns a cudaError_t
// (0 = launched).
extern "C" int bst_xn_mma(int dtype, int bsize, int hs, int trans, const void* w, const void* x,
                          void* y, const long long* strides, const int* plan,
                          const int* ent_w, const int* ent_x, int batch, int heads,
                          int lut_heads, int rows, int blocks, int items, int ctx_in,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs <= 0 || hs % 8 || items <= 0 || items % 2 || items / 2 > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, trans, XN_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, trans, XN_ARGS);
  return cudaErrorInvalidValue;
}
