// Fused block-sparse attention dk/dv on Hopper's warpgroup products
// (wgmma) fed by TMA, bf16 and f16, block size 64, head size 64: from q,
// k, v, dO, the forward's per-row log-sum-exp lse and D = rowsum(dO o O),
//   dv = round(P)^T dO,   dk = round(dS)^T q,
// P = exp(scale q k^T - lse) (0 where the mask hides a key) and
// dS = P o (dO v^T - D) * scale recomputed in registers, so neither P nor
// dS reaches shared or device memory; dk and dv come out in f32.
//
// Replaces, for bf16 and f16 inputs at bs 64 and hs 64, the TPU kernel
// fused_attention_dkv / _attn_dkv_kernel
// (blocksparse_tpu/kernels/bst_attn.py:1141), as bst_attn_bwd_mma.cu did
// before it; every other size stays there (attn_kernel in
// kernels/bst_attn.py is the rule, by shape only; dq runs
// bst_attn_dq_wgmma.cu).  hs 128 stays there
// too: its dk and dv accumulators (64 x 128 f32 each) and the 64 x 64 S^T
// and dP^T would hold 192 f32 registers a consumer thread before P and dS,
// past what two consumer warpgroups can keep.  Each key row sums its
// entries in its key-row (tn) CSR order, whose mask codes were classified
// on the transposed mask blocks; round() is the rounding to the input
// type that packing an accumulator pair into an A register does (as the
// plain version and _attn_dkv_kernel round).  No atomics: two runs give
// the same bits.  A key row no query sees stores zeros (a shard's tables,
// parallel/sequence.py).
//
// Bound on the H100 at the LM's shape (batch 8 x ctx 2048, 8 heads of 64,
// 312 blocks of 64 x 64): four products of e = 5.23 G multiply-adds, 41.9
// GFLOP (0.0423 ms at 989 TFLOP/s), against q, k, v, dO, lse and D in and
// dk, dv out in f32, 135 MB (0.040 ms at 3.35 TB/s): bound by operations,
// barely.  bst_attn_bwd_mma.cu ran at 221 TFLOP/s: one thread block of
// four warps a key block-row, each warp reading every q and dO operand
// through ldmatrix, and each key row re-reading its (q, dO) pairs from L2:
// 312 x 64 x 16 KB = 0.33 GB a call.
//
// The design.  A thread block takes two key block-rows of one (batch,
// head) and walks the union of their query blocks (pair_plan over the tn
// CSR: the rows paired in their launch order, so on the LM's layout the
// summary columns, 12-32 entries, pair among themselves; each union entry
// a query block with a "which rows" mask and each row's mask code): 176
// (q, dO) loads instead of 312.  Warp-specialised and persistent: one
// thread block an SM walks the work items (pair, batch * head), the
// longest unions first.  A producer warp stages both rows' k and v once an
// item (double-buffered, so the next item's load overlaps this one's
// epilogue) and keeps a ring of STAGES slots full, each a union entry's q
// and dO tiles by TMA (boxes of 64 rows x 64 head columns in the 128-byte
// swizzle, read in place through 4-d maps (hs, heads, ctx, batch)) and its
// 64 lse and D values by a bulk copy.  Two consumer warpgroups own one key
// row each (64 rows, registers raised by setmaxnreg): S^T = k q^T and
// dP^T = v dO^T by wgmma m64n64k16, k and v K-major A operands, q and dO
// K-major B operands; P^T and dS^T on the accumulator fragments with lse
// and D indexed by the column (the query); then dv += round(P^T) dO and
// dk += round(dS^T) q by the register-A wgmma, dO and q the same shared
// tiles read MN-major under a second descriptor.  A warpgroup issues
// entry e's S^T and dP^T before entry e - 1's dk/dv products and makes
// e's P^T and dS^T while those run.  A union entry whose mask bit a
// warpgroup lacks runs as one whose queries are all hidden (code 0): P^T
// and dS^T are 0 and dk, dv keep their bits; skipping it under a branch
// made ptxas serialize every product (C7520), as in the forward.  The
// mask is a select inside a branch on the warpgroup's code, and the exp
// runs on every element before it: per-element branches cost more than
// the rest of the step.
// q, k, v and dO must start on 16 bytes with batch and row strides that
// are multiples of 16 bytes, lse and D on 16 bytes (the wrapper copies a
// view that is not).
#include "bst_attn.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BS = 64, HS = 64;                   // block and head size
constexpr int CONSUMERS = 256;                     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;           // and the producer warpgroup
constexpr int TILE = BS * 128;                     // a 64 x 64 box, 128-byte rows
constexpr int KVBUF = 4 * TILE;                    // both rows' k, v
constexpr int SLOT = 2 * TILE + 1024;              // q, dO, then lse and D (256 B each)
constexpr int STAGES = 5;
constexpr float LOG2E = 1.4426950408889634f;
// 1 KB to align the tiles to 1024 bytes, the ring, two k/v buffers, a full
// and an empty mbarrier a slot and a k/v buffer
constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT + 2 * KVBUF + (2 * STAGES + 4) * 8;

struct DkvArgs {
  const float *lse, *dvec;
  float *dk, *dv;
  const int *pair_rows, *pair_ptr;
  const int4* pair_ent;
  const signed char* uniq;
  int batch, heads, lut_heads, ctx_blks_q, rows, pairs, items;
  float scale;
};

// lane 0 of each consumer warp arrives once every lane is past its reads
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// dv += P^T (A registers) . dO and dk += dS^T . q over the entry's 64
// queries, dO and q MN-major (their rows are the contraction)
template <typename T>
__device__ __forceinline__ void dkv_products(float (&dk)[32], float (&dv)[32],
                                             const uint32_t (&pa)[4][4],
                                             const uint32_t (&sa)[4][4], uint32_t qs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ra<1>(dv, pa[kk], sw128_desc(qs + TILE, true) + 128 * kk, 1, T());
    wgmma_ra<1>(dk, sa[kk], sw128_desc(qs, true) + 128 * kk, 1, T());
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
bst_attn_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, const DkvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kvs = ring + STAGES * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + 2 * KVBUF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvfull = empty + STAGES;
  uint64_t* kvempty = kvfull + 2;

  const int tid = threadIdx.x;
  const size_t ctx_q = (size_t)a.ctx_blks_q * BS;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(kvfull + i, 1);
      mbar_init(kvempty + i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every load, item after item: both
    // key rows' k and v into buffer n % 2, then each union entry's q, dO,
    // lse and D ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      int it = 0;  // ring steps so far: slot it % STAGES, round it / STAGES
      for (int item = blockIdx.x, n = 0; item < a.items; item += gridDim.x, ++n) {
        const PairItem w =
            pair_item(item, a.pair_rows, a.pair_ptr, a.batch, a.heads, a.lut_heads, a.pairs);
        const int kb = n & 1;
        mbar_wait(kvempty + kb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(kvfull + kb, KVBUF);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // an odd last row's partner loads the row again (never stored)
          const int row = w.row[r] < 0 ? w.row[0] : w.row[r];
          unsigned char* dst = kvs + kb * KVBUF + 2 * r * TILE;
          tma_load_4d(dst, &kmap, kvfull + kb, 0, w.h, row * BS, w.b);
          tma_load_4d(dst + TILE, &vmap, kvfull + kb, 0, w.h, row * BS, w.b);
        }
        const size_t lrow = (size_t)w.bh * ctx_q;
        for (int e = w.e0; e < w.e1; ++e, ++it) {
          const int qblk = __ldg(&a.pair_ent[e].x), slot = it % STAGES;
          mbar_wait(empty + slot, ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + slot * SLOT;
          mbar_expect_tx(full + slot, 2 * TILE + 2 * BS * 4);
          tma_load_4d(st, &qmap, full + slot, 0, w.h, qblk * BS, w.b);
          tma_load_4d(st + TILE, &omap, full + slot, 0, w.h, qblk * BS, w.b);
          bulk_load(st + 2 * TILE, a.lse + lrow + (size_t)qblk * BS, BS * 4, full + slot);
          bulk_load(st + 2 * TILE + BS * 4, a.dvec + lrow + (size_t)qblk * BS, BS * 4,
                    full + slot);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns key row w.row[wg] of each item ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, lane = tid & 31, tg = lane & 3;
    const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's key rows r0, r0 + 8
    const float scale = a.scale;
    const size_t state = (size_t)a.heads * HS, ctx_k = (size_t)a.rows * BS;
    int it = 0;
    for (int item = blockIdx.x, n = 0; item < a.items; item += gridDim.x, ++n) {
      const PairItem w =
          pair_item(item, a.pair_rows, a.pair_ptr, a.batch, a.heads, a.lut_heads, a.pairs);
      const int row = wg ? w.row[1] : w.row[0], kb = n & 1;
      const uint32_t ks = smem_addr(kvs + kb * KVBUF + 2 * wg * TILE), vs = ks + TILE;
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
      uint32_t pa[4][4], sa[4][4];  // the last entry's P^T and dS^T
      mbar_wait(kvfull + kb, (n >> 1) & 1);
      // S^T = k q^T and dP^T = v dO^T of a union entry into s and dp (every
      // fence, commit and wait of the loop below runs on every path: a
      // product issued or waited for under a branch makes ptxas serialize
      // them all)
      auto scores = [&](float (&s)[32], float (&dp)[32], uint32_t qs) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<0, 0>(s, sw128_desc(ks, false) + 2 * kk, sw128_desc(qs, false) + 2 * kk, kk > 0,
                      T());
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma<0, 0>(dp, sw128_desc(vs, false) + 2 * kk, sw128_desc(qs + TILE, false) + 2 * kk,
                      kk > 0, T());
        wgmma_commit();
      };
      // P^T and dS^T in place of S^T and dP^T under the entry's mask code
      // (0: not this row's block, all hidden), column (query) cl's lse and
      // D read from the slot.  The code is the warpgroup's: each branch is
      // uniform, and inside one the mask is a select (per-element branches
      // cost more than the rest)
      auto grads = [&](float (&s)[32], float (&dp)[32], int code, const float* ld) {
        const signed char* u = a.uniq + (size_t)max(code - MASK_UNIQ0, 0) * BS * BS;
        auto one = [&](bool uniq_block) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = 8 * j + 2 * tg;  // the query columns cl, cl + 1
            const float2 l2 = *reinterpret_cast<const float2*>(ld + cl);
            const float2 d2 = *reinterpret_cast<const float2*>(ld + BS + cl);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int rr = r0 + (i >> 1) * 8, cc = cl + (i & 1);
              const bool vis = uniq_block ? __ldg(u + rr * BS + cc) != 0
                               : code == MASK_FULL ? true
                               : code == MASK_TRIL ? rr >= cc
                                                   : code == MASK_TRIU && rr <= cc;
              // exp2 on every element, then a select (with lse = -inf the
              // exp is +inf)
              const float x = exp2_ftz(fmaf(s[4 * j + i], scale, -(i & 1 ? l2.y : l2.x)) * LOG2E);
              const float p = vis ? x : 0.f;
              s[4 * j + i] = p;                                                    // P^T
              dp[4 * j + i] = p * (dp[4 * j + i] - (i & 1 ? d2.y : d2.x)) * scale;  // dS^T
            }
          }
        };
        if (code < MASK_UNIQ0)
          one(false);
        else
          one(true);
      };
      auto to_a = [&](const float (&s)[32], const float (&dp)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pa[kk][q] = pack2(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], T());
            sa[kk][q] = pack2(dp[8 * kk + 2 * q], dp[8 * kk + 2 * q + 1], T());
          }
          fence_regs(pa[kk]);
          fence_regs(sa[kk]);
        }
      };
      // The union entries in order.  A union entry that is not this row's
      // block runs as one whose queries are all hidden: P^T and dS^T are 0
      // and dk, dv keep their bits.  Entry e's S^T and dP^T are issued
      // before entry e - 1's dk/dv products, and its P^T and dS^T made
      // while those run (FlashAttention-3's intra-warpgroup overlap).
      int pslot = 0;
      uint32_t pq = 0;  // the last entry's q tile (dO follows it)
      if (w.e0 < w.e1) {
        const int4 ent = __ldg(a.pair_ent + w.e0);
        const int slot = it % STAGES;
        const uint32_t qs = smem_addr(ring + slot * SLOT);
        mbar_wait(full + slot, (it / STAGES) & 1);
        float s[32], dp[32];
        scores(s, dp, qs);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        grads(s, dp, (ent.y >> wg) & 1 ? (wg ? ent.w : ent.z) : MASK_ABSENT,
              reinterpret_cast<const float*>(ring + slot * SLOT + 2 * TILE));
        to_a(s, dp);
        pslot = slot;
        pq = qs;
        ++it;
      }
      for (int e = w.e0 + 1; e < w.e1; ++e, ++it) {
        const int4 ent = __ldg(a.pair_ent + e);
        const int slot = it % STAGES;
        const uint32_t qs = smem_addr(ring + slot * SLOT);
        mbar_wait(full + slot, (it / STAGES) & 1);
        float s[32], dp[32];
        scores(s, dp, qs);
        dkv_products<T>(dk, dv, pa, sa, pq);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        grads(s, dp, (ent.y >> wg) & 1 ? (wg ? ent.w : ent.z) : MASK_ABSENT,
              reinterpret_cast<const float*>(ring + slot * SLOT + 2 * TILE));
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        release(empty + pslot);
        to_a(s, dp);
        pslot = slot;
        pq = qs;
      }
      // the item's S^T and dP^T products, the only readers of k and v, are
      // done
      release(kvempty + kb);
      if (w.e0 < w.e1) {
        wgmma_fence();
        dkv_products<T>(dk, dv, pa, sa, pq);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        release(empty + pslot);
      }
      if (row < 0) continue;  // an odd last row's empty partner

      const size_t off =
          ((size_t)w.b * ctx_k + (size_t)row * BS + r0) * state + w.h * HS + 2 * tg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store2(a.dk + off + 8 * j, dk[4 * j], dk[4 * j + 1]);
        store2(a.dk + off + 8 * state + 8 * j, dk[4 * j + 2], dk[4 * j + 3]);
        store2(a.dv + off + 8 * j, dv[4 * j], dv[4 * j + 1]);
        store2(a.dv + off + 8 * state + 8 * j, dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const long long* st, const DkvArgs& a, cudaStream_t stream) {
  auto kernel = bst_attn_dkv_wgmma_kernel<T>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, SMEM, ready);
  if (err != cudaSuccess) return err;
  if (a.items == 0) return cudaSuccess;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters, so a replay reads the captured tensors)
  const int ctx_q = a.ctx_blks_q * BS, ctx_k = a.rows * BS;
  CUtensorMap qmap, kmap, vmap, omap;
  err = head_rows_map<T>(&qmap, q, HS, a.heads, ctx_q, a.batch, st[1], st[0], BS);
  if (err == cudaSuccess)
    err = head_rows_map<T>(&kmap, k, HS, a.heads, ctx_k, a.batch, st[3], st[2], BS);
  if (err == cudaSuccess)
    err = head_rows_map<T>(&vmap, v, HS, a.heads, ctx_k, a.batch, st[5], st[4], BS);
  if (err == cudaSuccess)
    err = head_rows_map<T>(&omap, dout, HS, a.heads, ctx_q, a.batch, st[7], st[6], BS);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = static_cast<unsigned>(a.items < sms ? a.items : sms);
  kernel<<<grid, THREADS, SMEM, stream>>>(qmap, kmap, vmap, omap, a);
  return cudaGetLastError();
}

// registers, local (spilled) bytes, dynamic shared memory, resident thread
// blocks an SM and ring slots of one instantiation
template <typename T>
cudaError_t info_of(int* info) {
  auto kernel = bst_attn_dkv_wgmma_kernel<T>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, SMEM, ready);
  cudaFuncAttributes at;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, SMEM);
  if (err != cudaSuccess) return err;
  info[0] = at.numRegs;
  info[1] = static_cast<int>(at.localSizeBytes);
  info[2] = static_cast<int>(SMEM);
  info[3] = blocks;
  info[4] = STAGES;
  return cudaSuccess;
}

}  // namespace

// dtype 1 = bfloat16, 2 = float16; hs 64; block size 64; anything else
// returns cudaErrorInvalidValue.  q, dout (batch, ctx_q, heads * hs), k, v
// (batch, ctx_k, heads * hs) through strides {q batch, q row, k batch, k
// row, v batch, v row, dO batch, dO row} (elements); lse and dvec (batch,
// heads, ctx_q) f32, contiguous; dk and dv (batch, ctx_k, heads * hs) f32,
// contiguous.  pair_rows (lut_heads, P, 2), pair_ptr (lut_heads * (P + 1))
// and pair_ent (n, 4), 16-byte aligned: pair_plan's arrays over the
// key-row CSR, P = ceil(ctx_blks_k / 2); uniq the (n_uniq * 64, 64) int8
// table of the transposed mask blocks.  q, k, v and dO start on 16 bytes
// with batch and row strides that are multiples of 8 elements; lse and
// dvec on 16 bytes.  Returns a cudaError_t (0 = launched).
extern "C" int bst_attn_dkv_wgmma(int dtype, int hs, const void* q, const void* k,
                                  const void* v, const void* dout, const void* lse,
                                  const void* dvec, void* dk, void* dv,
                                  const long long* strides, const int* pair_rows,
                                  const int* pair_ptr, const int* pair_ent,
                                  const signed char* uniq, int batch, int heads, int lut_heads,
                                  int ctx_blks_q, int ctx_blks_k, float scale, void* stream) {
  const int pairs = (ctx_blks_k + 1) / 2;
  const long long items = (long long)pairs * batch * heads;
  if (hs != HS || batch < 0 || ctx_blks_k < 0 || items > 0x7fffffff)
    return cudaErrorInvalidValue;
  const DkvArgs a{static_cast<const float*>(lse), static_cast<const float*>(dvec),
                  static_cast<float*>(dk), static_cast<float*>(dv), pair_rows, pair_ptr,
                  reinterpret_cast<const int4*>(pair_ent), uniq, batch, heads, lut_heads,
                  ctx_blks_q, ctx_blks_k, pairs, static_cast<int>(items), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, dout, strides, a, s);
  if (dtype == 2) return launch<__half>(q, k, v, dout, strides, a, s);
  return cudaErrorInvalidValue;
}

// info[0..4] of the instantiation for dtype (1 bf16, 2 f16): registers,
// local bytes, dynamic shared memory, resident thread blocks an SM, ring
// slots.  Returns a cudaError_t.
extern "C" int bst_attn_dkv_wgmma_info(int dtype, int* info) {
  if (dtype == 1) return info_of<__nv_bfloat16>(info);
  if (dtype == 2) return info_of<__half>(info);
  return cudaErrorInvalidValue;
}
