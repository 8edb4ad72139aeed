// Fused block-sparse attention dq on Hopper's warpgroup products (wgmma)
// fed by TMA, bf16 and f16, block size 64, head sizes 64 and 128: from q,
// k, v, dO, the forward's per-row log-sum-exp lse and D = rowsum(dO o O),
//   dq = round(dS) k,   dS = P o (dO v^T - D) * scale,
// P = exp(scale q k^T - lse) (0 where the mask hides a key) recomputed in
// registers, so neither P nor dS reaches shared or device memory; round()
// is the rounding to the input type that packing an accumulator pair into
// an A register does (as the plain version and _attn_dq_kernel round).
// dq is rounded once to the input type, or stored in f32 (which 2: ring
// attention sums a row's dq over the launches of its key chunks,
// parallel/sequence.py, as fused_attention_dq(out_dtype=f32) does).
//
// Replaces, for bf16 and f16 inputs at bs 64, the TPU kernel
// fused_attention_dq / _attn_dq_kernel (blocksparse_tpu/kernels/
// bst_attn.py:1084, body :891), as bst_attn_bwd_mma.cu did before it; bs
// 16 and 32 (and the bs-8 view), hs 16 and 32, and the key contexts where
// it measured slower stay there (attn_kernel in kernels/bst_attn.py is the
// rule, by shape only).  Each query row sums its entries in its CSR order
// (the forward's nn CSR and codes); no atomics: two runs give the same
// bits.  A query row that sees no key stores zeros (a shard's tables,
// parallel/sequence.py).
//
// Bound on the H100 at the LM's shape (batch 8 x ctx 2048, 8 heads of 64,
// 312 blocks of 64 x 64): three products of e = 5.23 G multiply-adds,
// 31.4 GFLOP (0.0318 ms at 989 TFLOP/s), against q, k, v, dO in and dq out
// (and lse, D), ~84 MB (0.025 ms at 3.35 TB/s): bound by operations.
// bst_attn_bwd_mma.cu ran at 229 TFLOP/s: one thread block of four warps
// a query block-row, each warp reading every k and v operand through
// ldmatrix, and each block-row re-reading its (k, v) pairs from L2.
//
// The design, bst_attn_fwd_wgmma.cu's work with bst_attn_dkv_wgmma.cu's
// products.  A thread block takes two query block-rows of one (batch,
// head) and walks the union of their key blocks (pair_plan over the nn
// CSR, the forward's tables as they are: 170 (k, v) loads instead of 312
// on the LM's layout).  Warp-specialised and persistent: one thread block
// an SM walks the work items (pair, batch * head), the longest unions
// first.  A producer warp stages both rows' q and dO tiles once an item
// (double-buffered, so the next item's loads overlap this one's last
// products and epilogue) and keeps a ring of STAGES (k, v) slots full,
// one union entry a slot, all by TMA (boxes of 64 rows x 64 head columns
// in the 128-byte swizzle, read in place through 4-d maps (hs, heads,
// ctx, batch)).  The consumers read their rows' lse and D (4 values a
// thread) from device memory at the item's start: staging them too would
// take the 2 KB that hs 128's third ring slot needs.  Two consumer
// warpgroups own one query row each (64 rows, registers raised by
// setmaxnreg): S = q k^T and dP = dO v^T by wgmma m64n64k16, q and dO
// K-major A operands, k and v K-major B operands; P and dS on the
// accumulator fragments with the row's lse and D; then dq += round(dS) k
// by the register-A wgmma, k the same shared tile read MN-major under a
// second descriptor.  A warpgroup issues entry e's S and dP before entry
// e - 1's dq product and makes e's dS while it runs.  A union entry whose
// mask bit a warpgroup lacks runs as one whose keys are all hidden (code
// 0): dS is 0 and dq keeps its bits; skipping it under a branch makes
// ptxas serialize every product (C7520), as in the forward and dk/dv.
// What bounds it: the consumers' issue of dS between the products, not
// the loads or the tensor cores, so dS costs an element one FFMA, the
// SFU's ex2 and an FFMA and FMUL (p = 2^(c s - lse log2 e) with c = scale
// log2 e, dS = p (scale dP - scale D)), and a block every key of which is
// visible takes no mask (an element's six operations before made dq 1.3x
// slower at the LM's shape: PERF.md).  Elsewhere the mask is a select
// inside a branch on the warpgroup's code, and the exp runs on every
// element before it (with lse = -inf the exp is +inf: the select, never a
// product, zeroes it).
// q, k, v and dO must start on 16 bytes with batch and row strides that
// are multiples of 16 bytes (the wrapper copies a view that is not).
#include "bst_attn.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BS = 64;                             // rows a consumer warpgroup owns
constexpr int CONSUMERS = 256;                     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;           // and the producer warpgroup
constexpr int TILE = BS * 128;                     // a 64 x 64 box, 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;

template <int HS> struct Cfg {
  static constexpr int NC = HS / 64;               // 64-column boxes of a head
  static constexpr int QBUF = 4 * NC * TILE;       // both rows' q, then dO
  static constexpr int SLOT = 2 * NC * TILE;       // k, then v, of one key block
  static constexpr int STAGES = HS == 64 ? 5 : 3;

  // 1 KB to align the tiles to 1024 bytes, the ring, two q/dO buffers, a
  // full and an empty mbarrier a slot and a q/dO buffer
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT + 2 * QBUF + (2 * STAGES + 4) * 8;
};

struct DqArgs {
  const float *lse, *dvec;
  void* dq;
  const int *pair_rows, *pair_ptr;
  const int4* pair_ent;
  const signed char* uniq;
  int batch, heads, lut_heads, rows, pairs, items;
  float scale;
};

// lane 0 of each consumer warp arrives once every lane is past its reads
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// dq (64 x hs) += dS (64 x 64 keys, A registers) . k (64 keys x hs,
// MN-major: its rows are the contraction)
template <typename T, int NC>
__device__ __forceinline__ void dq_product(float (&dq)[NC][32], const uint32_t (&sa)[4][4],
                                           uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ra<1>(dq[c], sa[kk], sw128_desc(ks + c * TILE, true) + 128 * kk, 1, T());
}

// O: dq's type, T (which 0) or float (which 2)
template <typename T, int HS, typename O>
__global__ void __launch_bounds__(THREADS, 1)
bst_attn_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap omap, const DqArgs a) {
  using C = Cfg<HS>;
  constexpr int NC = C::NC, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = ring + ST * C::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + 2 * C::QBUF);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + 2;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every load, item after item: both
    // query rows' q and dO into buffer n % 2, then each union entry's
    // (k, v) ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      int it = 0;  // ring steps so far: slot it % ST, round it / ST
      for (int item = blockIdx.x, n = 0; item < a.items; item += gridDim.x, ++n) {
        const PairItem w =
            pair_item(item, a.pair_rows, a.pair_ptr, a.batch, a.heads, a.lut_heads, a.pairs);
        const int qb = n & 1;
        mbar_wait(qempty + qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull + qb, C::QBUF);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // an odd last row's partner loads the row again (never stored)
          const int row = w.row[r] < 0 ? w.row[0] : w.row[r];
          unsigned char* dst = qs + qb * C::QBUF + 2 * r * NC * TILE;
          for (int c = 0; c < NC; ++c) {
            tma_load_4d(dst + c * TILE, &qmap, qfull + qb, c * 64, w.h, row * BS, w.b);
            tma_load_4d(dst + (NC + c) * TILE, &omap, qfull + qb, c * 64, w.h, row * BS, w.b);
          }
        }
        for (int e = w.e0; e < w.e1; ++e, ++it) {
          const int kb = __ldg(&a.pair_ent[e].x), slot = it % ST;
          mbar_wait(empty + slot, ((it / ST) & 1) ^ 1);
          unsigned char* st = ring + slot * C::SLOT;
          mbar_expect_tx(full + slot, C::SLOT);
          for (int c = 0; c < NC; ++c) {
            tma_load_4d(st + c * TILE, &kmap, full + slot, c * 64, w.h, kb * BS, w.b);
            tma_load_4d(st + (NC + c) * TILE, &vmap, full + slot, c * 64, w.h, kb * BS, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query row w.row[wg] of each item ----
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, lane = tid & 31, tg = lane & 3;
    const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const float scale = a.scale, c = scale * LOG2E;
    const size_t state = (size_t)a.heads * HS, ctx_q = (size_t)a.rows * BS;
    int it = 0;
    for (int item = blockIdx.x, n = 0; item < a.items; item += gridDim.x, ++n) {
      const PairItem w =
          pair_item(item, a.pair_rows, a.pair_ptr, a.batch, a.heads, a.lut_heads, a.pairs);
      const int row = wg ? w.row[1] : w.row[0], qb = n & 1;
      // rows r0 and r0 + 8: lse log2(e) and D scale (an odd last row's
      // partner reads the row's own: every entry is foreign to it)
      const size_t lrow = (size_t)w.bh * ctx_q + (size_t)(row < 0 ? w.row[0] : row) * BS + r0;
      const float l2[2] = {__ldg(a.lse + lrow) * LOG2E, __ldg(a.lse + lrow + 8) * LOG2E};
      const float dsc[2] = {__ldg(a.dvec + lrow) * scale, __ldg(a.dvec + lrow + 8) * scale};
      const uint32_t qa = smem_addr(qs + qb * C::QBUF + 2 * wg * NC * TILE), oa = qa + NC * TILE;
      float dq[NC][32];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[cc][i] = 0.f;
      uint32_t sa[4][4];  // the last entry's dS, pending its dS k
      mbar_wait(qfull + qb, (n >> 1) & 1);
      // S = q k^T and dP = dO v^T of a union entry into s and dp (every
      // fence, commit and wait of the loop below runs on every path: a
      // product issued or waited for under a branch makes ptxas serialize
      // them all)
      auto scores = [&](float (&s)[32], float (&dp)[32], uint32_t ks) {
        wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<0, 0>(s, sw128_desc(qa + cc * TILE, false) + 2 * kk,
                        sw128_desc(ks + cc * TILE, false) + 2 * kk, cc > 0 || kk > 0, T());
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<0, 0>(dp, sw128_desc(oa + cc * TILE, false) + 2 * kk,
                        sw128_desc(ks + (NC + cc) * TILE, false) + 2 * kk, cc > 0 || kk > 0,
                        T());
        wgmma_commit();
      };
      // dS in place of dP under the entry's mask code (0: not this row's
      // block, all hidden), in base-2 units: p = 2^(c s - lse log2(e)) and
      // dS = p (scale dP - scale D) by one FFMA each.  The code is the
      // warpgroup's: each branch is uniform; an all-visible block takes no
      // select, and inside the others the mask is a select (per-element
      // branches cost more than the rest)
      auto grads = [&](const float (&s)[32], float (&dp)[32], int code) {
        auto one = [&](auto vis) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int hi = (i >> 1) & 1;
            // exp2 on every element, then a select (with lse = -inf the
            // exp is +inf)
            const float x = exp2_ftz(fmaf(s[i], c, -l2[hi]));
            const float p = vis(r0 + hi * 8, (i >> 2) * 8 + 2 * tg + (i & 1)) ? x : 0.f;
            dp[i] = p * fmaf(dp[i], scale, -dsc[hi]);  // dS
          }
        };
        if (code == MASK_FULL) {
          one([](int, int) { return true; });
        } else if (code < MASK_UNIQ0) {  // absent, the lower or upper triangle
          one([&](int rr, int cc) {
            return code == MASK_TRIL ? rr >= cc : code == MASK_TRIU && rr <= cc;
          });
        } else {  // a block of the unique table
          const signed char* u = a.uniq + (size_t)(code - MASK_UNIQ0) * BS * BS;
          one([&](int rr, int cc) { return __ldg(u + rr * BS + cc) != 0; });
        }
      };
      // dS rounded once into the A registers of the k16 steps over the
      // entry's 64 keys
      auto to_a = [&](const float (&ds)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sa[kk][q] = pack2(ds[8 * kk + 2 * q], ds[8 * kk + 2 * q + 1], T());
          fence_regs(sa[kk]);
        }
      };
      auto code_of = [&](const int4& ent) {
        return (ent.y >> wg) & 1 ? (wg ? ent.w : ent.z) : MASK_ABSENT;
      };
      // The union entries in order.  A union entry that is not this row's
      // block runs as one whose keys are all hidden: dS is 0 and dq keeps
      // its bits.  Entry e's S and dP are issued before entry e - 1's dq
      // product, and its dS made while that runs (FlashAttention-3's
      // intra-warpgroup overlap).
      int pslot = 0;
      uint32_t pk = 0;  // the last entry's k tile
      if (w.e0 < w.e1) {
        const int4 ent = __ldg(a.pair_ent + w.e0);
        const int slot = it % ST;
        const uint32_t ks = smem_addr(ring + slot * C::SLOT);
        mbar_wait(full + slot, (it / ST) & 1);
        float s[32], dp[32];
        scores(s, dp, ks);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        grads(s, dp, code_of(ent));
        to_a(dp);
        pslot = slot;
        pk = ks;
        ++it;
      }
      for (int e = w.e0 + 1; e < w.e1; ++e, ++it) {
        const int4 ent = __ldg(a.pair_ent + e);
        const int slot = it % ST;
        const uint32_t ks = smem_addr(ring + slot * C::SLOT);
        mbar_wait(full + slot, (it / ST) & 1);
        float s[32], dp[32];
        scores(s, dp, ks);
        dq_product<T, NC>(dq, sa, pk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        grads(s, dp, code_of(ent));
        wgmma_wait<0>();
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) fence_regs(dq[cc]);
        release(empty + pslot);
        to_a(dp);
        pslot = slot;
        pk = ks;
      }
      // the item's S and dP products, the only readers of q and dO, are
      // done
      release(qempty + qb);
      if (w.e0 < w.e1) {
        wgmma_fence();
        dq_product<T, NC>(dq, sa, pk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) fence_regs(dq[cc]);
        release(empty + pslot);
      }
      if (row < 0) continue;  // an odd last row's empty partner

      O* out = static_cast<O*>(a.dq) + ((size_t)w.b * ctx_q + (size_t)row * BS + r0) * state +
               w.h * HS + 2 * tg;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          store2(out + cc * 64 + j * 8, dq[cc][4 * j], dq[cc][4 * j + 1]);
          store2(out + 8 * state + cc * 64 + j * 8, dq[cc][4 * j + 2], dq[cc][4 * j + 3]);
        }
    }
  }
}

template <typename T, int HS, typename O>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const long long* st, const DqArgs& a, int ctx_k, cudaStream_t stream) {
  auto kernel = bst_attn_dq_wgmma_kernel<T, HS, O>;
  constexpr size_t bytes = Cfg<HS>::SMEM;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  if (a.items == 0) return cudaSuccess;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters, so a replay reads the captured tensors)
  const int ctx_q = a.rows * BS;
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
  kernel<<<grid, THREADS, bytes, stream>>>(qmap, kmap, vmap, omap, a);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch(int hs, const void* q, const void* k, const void* v, const void* dout,
                     const long long* st, const DqArgs& a, int ctx_k, cudaStream_t s) {
  switch (hs) {
    case 64: return launch<T, 64, O>(q, k, v, dout, st, a, ctx_k, s);
    case 128: return launch<T, 128, O>(q, k, v, dout, st, a, ctx_k, s);
    default: return cudaErrorInvalidValue;
  }
}

// registers, local (spilled) bytes, dynamic shared memory, resident thread
// blocks an SM and ring slots of one instantiation
template <typename T, int HS, typename O>
cudaError_t info_of(int* info) {
  auto kernel = bst_attn_dq_wgmma_kernel<T, HS, O>;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, Cfg<HS>::SMEM, ready);
  cudaFuncAttributes at;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, Cfg<HS>::SMEM);
  if (err != cudaSuccess) return err;
  info[0] = at.numRegs;
  info[1] = static_cast<int>(at.localSizeBytes);
  info[2] = static_cast<int>(Cfg<HS>::SMEM);
  info[3] = blocks;
  info[4] = Cfg<HS>::STAGES;
  return cudaSuccess;
}

template <typename T, typename O>
cudaError_t info_hs(int hs, int* info) {
  if (hs == 64) return info_of<T, 64, O>(info);
  if (hs == 128) return info_of<T, 128, O>(info);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 1 = bfloat16, 2 = float16; which 0 stores dq in the input type, 2
// in f32; hs 64 or 128; block size 64; anything else returns
// cudaErrorInvalidValue.  q, dout (batch, ctx_q, heads * hs), k, v (batch,
// ctx_k, heads * hs) through strides {q batch, q row, k batch, k row, v
// batch, v row, dO batch, dO row} (elements); lse and dvec (batch, heads,
// ctx_q) f32, contiguous; dq (batch, ctx_q, heads * hs), contiguous.
// pair_rows (lut_heads, P, 2), pair_ptr (lut_heads * (P + 1)) and pair_ent
// (n, 4), 16-byte aligned: pair_plan's arrays over the query-row CSR, P =
// ceil(ctx_blks_q / 2); uniq the (n_uniq * 64, 64) int8 mask table.  q,
// k, v and dO start on 16 bytes with batch and row strides that are
// multiples of 8 elements.  Returns a cudaError_t (0 = launched).
extern "C" int bst_attn_dq_wgmma(int dtype, int which, int hs, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* dvec, void* dq, const long long* strides,
                                 const int* pair_rows, const int* pair_ptr, const int* pair_ent,
                                 const signed char* uniq, int batch, int heads, int lut_heads,
                                 int ctx_blks_q, int ctx_blks_k, float scale, void* stream) {
  const int pairs = (ctx_blks_q + 1) / 2;
  const long long items = (long long)pairs * batch * heads;
  if ((which != 0 && which != 2) || batch < 0 || ctx_blks_q < 0 || items > 0x7fffffff)
    return cudaErrorInvalidValue;
  const DqArgs a{static_cast<const float*>(lse), static_cast<const float*>(dvec), dq,
                 pair_rows, pair_ptr, reinterpret_cast<const int4*>(pair_ent), uniq, batch,
                 heads, lut_heads, ctx_blks_q, pairs, static_cast<int>(items), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctx_k = ctx_blks_k * BS;
  if (dtype == 1)
    return which == 0 ? dispatch<__nv_bfloat16, __nv_bfloat16>(hs, q, k, v, dout, strides, a,
                                                                ctx_k, s)
                      : dispatch<__nv_bfloat16, float>(hs, q, k, v, dout, strides, a, ctx_k, s);
  if (dtype == 2)
    return which == 0 ? dispatch<__half, __half>(hs, q, k, v, dout, strides, a, ctx_k, s)
                      : dispatch<__half, float>(hs, q, k, v, dout, strides, a, ctx_k, s);
  return cudaErrorInvalidValue;
}

// info[0..4] of the instantiation for dtype (1 bf16, 2 f16), which (0 dq
// in the input type, 2 in f32) and hs (64, 128): registers, local bytes,
// dynamic shared memory, resident thread blocks an SM, ring slots.
// Returns a cudaError_t.
extern "C" int bst_attn_dq_wgmma_info(int dtype, int which, int hs, int* info) {
  if (which != 0 && which != 2) return cudaErrorInvalidValue;
  if (dtype == 1)
    return which == 0 ? info_hs<__nv_bfloat16, __nv_bfloat16>(hs, info)
                      : info_hs<__nv_bfloat16, float>(hs, info);
  if (dtype == 2)
    return which == 0 ? info_hs<__half, __half>(hs, info) : info_hs<__half, float>(hs, info);
  return cudaErrorInvalidValue;
}
