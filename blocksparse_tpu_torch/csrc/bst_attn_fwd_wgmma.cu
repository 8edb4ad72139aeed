// Fused block-sparse attention forward on Hopper's warpgroup products
// (wgmma) fed by TMA, bf16 and f16, block size 64, head sizes 64 and 128:
//   out = softmax(scale * q k^T + mask) v over a block layout,
// with an online softmax, so the scores never leave registers; optionally
// the per-row log-sum-exp lse = m + log(l) (f32) the backward reads.
//
// Replaces, for bf16 and f16 inputs at bs 64, the TPU kernels
// fused_attention_fwd / _attn_kernel (lse == null) and
// fused_attention_fwd_lse / _attn_fwd_lse_kernel
// (blocksparse_tpu/kernels/bst_attn.py:677 and :832), as
// bst_attn_fwd_mma.cu did before it; bs 16 and 32 (and the bs-8 view) and
// the head sizes this source is not built for stay there (attn_kernel in
// kernels/bst_attn.py is the rule, by shape only).  Each query row sums
// its entries in its CSR order, as _attn_kernel does:
//   m' = max(m, rowmax(c s)),  alpha = 2^(m - m'),  p = 2^(c s - m'),
//   l' = l alpha + rowsum(p),  acc' = acc alpha + round(p) v,
// c = scale * log2(e), l summing the unrounded p, round() the rounding to
// the input type that packing p into the PV product's A registers does;
// then out = acc / l, rounded once.  A query row that sees no key gives
// zeros and lse = -inf.  No atomics: two runs give the same bits.
//
// Bound on the H100 at the LM's shape (batch 8 x ctx 2048, 8 heads of 64,
// 312 blocks of 64 x 64): two products of e = 5.23 G multiply-adds, 20.9
// GFLOP (0.0212 ms at 989 TFLOP/s), against q, k, v and out, 67 MB (0.020
// ms at 3.35 TB/s): bound by operations, barely.  bst_attn_fwd_mma.cu ran
// at 192 TFLOP/s: one thread block of four warps a query block-row, each
// warp reading every k and v operand through ldmatrix, and each block-row
// re-reading its (k, v) pairs from L2: 312 x 64 x 16 KB = 0.33 GB a call.
//
// The design.  A thread block takes two query block-rows of one (batch,
// head) and walks the union of their key blocks (pair_plan: the rows
// paired in their launch order, each union entry a key block with a
// "which rows" mask and each row's mask code), so a key block both rows
// see is loaded once: 170 (k, v) loads instead of 312 on the LM's layout.
// Warp-specialised and persistent: one thread block an SM walks the work
// items (pair, batch * head), the pairs with the longest unions first.
// A producer warp keeps a ring of STAGES (k, v) slots full by TMA (boxes
// of 64 rows x 64 head columns in the 128-byte swizzle, read in place
// from the packed (batch, ctx, heads * hs) activations through 4-d maps
// (hs, heads, ctx, batch)) and double-buffers the pair's two q tiles, so
// the next item's loads overlap this one's epilogue.  Two consumer
// warpgroups own one query row of the pair each (64 rows, 128 threads,
// registers raised by setmaxnreg): S = q k^T by wgmma m64n64k16 with q
// and k as K-major shared-memory operands, the mask as a select and the
// online softmax on the accumulator fragments (the max taken on the raw
// scores, p = 2^(c s - m) by one FFMA and the SFU's ex2), then O += P v
// by the register-A wgmma: P rounded once into A registers, v an MN-major
// B operand.  A warpgroup issues entry e's S before entry e - 1's P v and
// runs e's softmax while P v is in flight (FlashAttention-3's
// intra-warpgroup overlap).  A union entry whose mask bit a warpgroup
// lacks runs as one whose keys are all hidden (code 0): it moves no bit
// of the row's max, sum or accumulators.  Skipping it instead, with the
// products issued or waited for under a branch, made ptxas serialize
// every product of the loop (C7520; measured slower on the H100), so
// every fence, commit and wait of the loop runs on every path and only
// the masks differ.  What bounds it (PERF.md): the consumers' issue of
// the softmax (some 350 instructions a warp an entry, two warps a
// sub-partition), not the loads or the tensor cores; the variants tried
// that did not help are listed there.  q, k and v
// must start on 16 bytes with batch and row strides that are multiples of
// 16 bytes (the wrapper copies a view that is not).
#include <float.h>

#include "bst_attn.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BS = 64;                             // rows a consumer warpgroup owns
constexpr int CONSUMERS = 256;                     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;           // and the producer warpgroup
constexpr int TILE = BS * 128;                     // a 64 x 64 box, 128-byte rows
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int HS> struct Cfg {
  static constexpr int NC = HS / 64;               // 64-column boxes of a head
  static constexpr int QBUF = 2 * NC * TILE;       // the pair's two q tiles
  static constexpr int SLOT = 2 * NC * TILE;       // k, then v, of one key block
  static constexpr int STAGES = 4;

  // 1 KB to align the tiles to 1024 bytes, the ring, two q buffers, a full
  // and an empty mbarrier a slot and a q buffer
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT + 2 * QBUF + (2 * STAGES + 4) * 8;
};

struct FwdArgs {
  void* out;
  float* lse;
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

// O (64 x hs) += P (64 x 64 keys, A registers) . v (64 keys x hs, MN-major)
template <typename T, int NC>
__device__ __forceinline__ void pv_product(float (&o)[NC][32], const uint32_t (&pa)[4][4],
                                           uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ra<1>(o[c], pa[kk], sw128_desc(vs + c * TILE, true) + 128 * kk, 1, T());
}

template <typename T, int HS>
__global__ void __launch_bounds__(THREADS, 1)
bst_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const FwdArgs a) {
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
    // ---- producer: one thread issues every load, item after item: the
    // pair's q tiles into q buffer n % 2, then each union entry's (k, v) ----
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
          for (int c = 0; c < NC; ++c)
            tma_load_4d(qs + qb * C::QBUF + (r * NC + c) * TILE, &qmap, qfull + qb, c * 64, w.h,
                        row * BS, w.b);
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
    // scores to base-2 units: c s = |scale| log2(e) (sign(scale) s), c at
    // least FLT_MIN, so that a hidden -inf times c stays -inf (scale 0
    // then gives p = 1, as it should)
    const bool neg = a.scale < 0.f;
    const float c = fmaxf(fabsf(a.scale), FLT_MIN) * LOG2E;
    const size_t state = (size_t)a.heads * HS, ctx_q = (size_t)a.rows * BS;
    int it = 0;
    for (int item = blockIdx.x, n = 0; item < a.items; item += gridDim.x, ++n) {
      const PairItem w =
          pair_item(item, a.pair_rows, a.pair_ptr, a.batch, a.heads, a.lut_heads, a.pairs);
      const int row = wg ? w.row[1] : w.row[0], qb = n & 1;
      const uint32_t qa = smem_addr(qs + qb * C::QBUF + wg * NC * TILE);
      float o[NC][32];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cc][i] = 0.f;
      // rows r0 and r0 + 8: the running max of c s, this thread's part of l
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      uint32_t pa[4][4];  // the last entry's P, pending its P v
      mbar_wait(qfull + qb, (n >> 1) & 1);
      // S = q k^T of one key block into s
      auto scores = [&](float (&s)[32], uint32_t ks) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<0, 0>(s, sw128_desc(qa + cc * TILE, false) + 2 * kk,
                        sw128_desc(ks + cc * TILE, false) + 2 * kk, cc > 0 || kk > 0, T());
      };
      // s (raw scores, sign-flipped where scale < 0) -> -inf where the
      // entry's mask code hides a key (0: not this row's block, all
      // hidden), and its rows' max.  The code is the warpgroup's: each
      // branch is uniform, and inside one the mask is a select
      // (per-element branches cost more than the softmax)
      auto mask_max = [&](float (&s)[32], int code, float (&mx)[2]) {
        mx[0] = mx[1] = -INFINITY;
        if (neg) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = -s[i];
        }
        if (code == MASK_FULL) {
#pragma unroll
          for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        } else if (code < MASK_UNIQ0) {  // absent, the lower or upper triangle
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int rr = r0 + ((i >> 1) & 1) * 8, cl = (i >> 2) * 8 + 2 * tg + (i & 1);
            const bool vis = code == MASK_TRIL ? rr >= cl : code == MASK_TRIU && rr <= cl;
            s[i] = vis ? s[i] : -INFINITY;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
          }
        } else {  // a block of the unique table
          const signed char* u = a.uniq + (size_t)(code - MASK_UNIQ0) * BS * BS;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int rr = r0 + ((i >> 1) & 1) * 8, cl = (i >> 2) * 8 + 2 * tg + (i & 1);
            s[i] = __ldg(u + rr * BS + cl) != 0 ? s[i] : -INFINITY;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
          }
        }
      };
      // p = 2^(c s - z) of a block in place (0 where s is -inf: hidden, or
      // a block not this row's), and its rows' sums.  No branch: one on
      // the code made the compiler keep both results and copy between
      // them every entry
      auto exp_sum = [&](float (&s)[32], const float (&z)[2], float (&rs)[2]) {
        rs[0] = rs[1] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = exp2_ftz(fmaf(s[i], c, -z[(i >> 1) & 1]));  // p, unrounded
          rs[(i >> 1) & 1] += s[i];
        }
      };
      // an entry's score block -> p in place, the online softmax's running
      // max (in units of c s) and sum moved on; the accumulators' rescale
      // in alpha
      auto softmax = [&](float (&s)[32], int code, float (&alpha)[2]) {
        float mx[2], z[2], rs[2];
        mask_max(s, code, mx);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the row max by a quad reduction (a row's columns sit in the
          // four threads of a quad); c > 0, so max(c s) = c max(s) exactly
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * c);
          // -inf while the row has seen no key: 2^(-inf - 0) = 0 makes alpha
          // and p 0 there, where -inf - (-inf) would be NaN
          z[r] = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = exp2_ftz(m[r] - z[r]);
          m[r] = m_new;
        }
        exp_sum(s, z, rs);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      };
      // P rounded once into the A registers of the k16 steps over the
      // entry's 64 keys
      auto to_a = [&](const float (&s)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pa[kk][q] = pack2(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], T());
          fence_regs(pa[kk]);
        }
      };
      // union entry e's slot, k tile and this row's mask code (0 where it
      // is not this row's block: it runs as one whose keys are all hidden,
      // which moves no bit of the row's max, sum or accumulators: alpha 1
      // or the row still empty, p 0), the slot waited for
      auto next_entry = [&](int e, int& slot, uint32_t& ks) {
        const int4 ent = __ldg(a.pair_ent + e);
        slot = it % ST;
        ks = smem_addr(ring + slot * C::SLOT);
        mbar_wait(full + slot, (it / ST) & 1);
        ++it;
        return (ent.y >> wg) & 1 ? (wg ? ent.w : ent.z) : MASK_ABSENT;
      };
      // The union entries in order.  Entry e's S is issued before entry
      // e - 1's P v, and its softmax runs while P v is in flight
      // (FlashAttention-3's intra-warpgroup overlap).  Every fence, commit
      // and wait runs on every path: a product issued or waited for under
      // a branch makes ptxas serialize them all.
      int pslot = 0;
      uint32_t pv = 0;  // the last entry's v tile, pending its P v
      if (w.e0 < w.e1) {
        int slot;
        uint32_t ks;
        const int code = next_entry(w.e0, slot, ks);
        float s[32], alpha[2];
        wgmma_fence();
        scores(s, ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax(s, code, alpha);
        to_a(s);
        pslot = slot;
        pv = ks + NC * TILE;
      }
      for (int e = w.e0 + 1; e < w.e1; ++e) {
        int slot;
        uint32_t ks;
        const int code = next_entry(e, slot, ks);
        float s[32], alpha[2];
        wgmma_fence();
        scores(s, ks);
        wgmma_commit();
        pv_product<T, NC>(o, pa, pv);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        softmax(s, code, alpha);
        wgmma_wait<0>();
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) fence_regs(o[cc]);
        release(empty + pslot);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[cc][i] *= alpha[(i >> 1) & 1];
          fence_regs(o[cc]);
        }
        to_a(s);
        pslot = slot;
        pv = ks + NC * TILE;
      }
      // the item's S products, the only readers of q, are done
      release(qempty + qb);
      if (w.e0 < w.e1) {
        wgmma_fence();
        pv_product<T, NC>(o, pa, pv);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) fence_regs(o[cc]);
        release(empty + pslot);
      }
      if (row < 0) continue;  // an odd last row's empty partner

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f, inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
      T* out = static_cast<T*>(a.out) + ((size_t)w.b * ctx_q + (size_t)row * BS + r0) * state +
               w.h * HS + 2 * tg;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          store2(out + cc * 64 + j * 8, o[cc][4 * j] * inv0, o[cc][4 * j + 1] * inv0);
          store2(out + 8 * state + cc * 64 + j * 8, o[cc][4 * j + 2] * inv1,
                 o[cc][4 * j + 3] * inv1);
        }
      if (a.lse != nullptr && tg == 0) {
        float* lp = a.lse + (size_t)w.bh * ctx_q + (size_t)row * BS + r0;
        lp[0] = l[0] > 0.f ? m[0] * LN2 + logf(l[0]) : -INFINITY;
        lp[8] = l[1] > 0.f ? m[1] * LN2 + logf(l[1]) : -INFINITY;
      }
    }
  }
}

template <typename T, int HS>
cudaError_t launch(const void* q, const void* k, const void* v, const long long* st,
                   const FwdArgs& a, int ctx_k, cudaStream_t stream) {
  auto kernel = bst_attn_fwd_wgmma_kernel<T, HS>;
  constexpr size_t bytes = Cfg<HS>::SMEM;
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  if (a.items == 0) return cudaSuccess;
  // the maps hold this call's addresses: encoded a call (a CUDA graph keeps
  // the launch's parameters, so a replay reads the captured tensors)
  CUtensorMap qmap, kmap, vmap;
  err = head_rows_map<T>(&qmap, q, HS, a.heads, a.rows * BS, a.batch, st[1], st[0], BS);
  if (err == cudaSuccess)
    err = head_rows_map<T>(&kmap, k, HS, a.heads, ctx_k, a.batch, st[3], st[2], BS);
  if (err == cudaSuccess)
    err = head_rows_map<T>(&vmap, v, HS, a.heads, ctx_k, a.batch, st[5], st[4], BS);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const unsigned grid = static_cast<unsigned>(a.items < sms ? a.items : sms);
  kernel<<<grid, THREADS, bytes, stream>>>(qmap, kmap, vmap, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hs, const void* q, const void* k, const void* v, const long long* st,
                     const FwdArgs& a, int ctx_k, cudaStream_t s) {
  switch (hs) {
    case 64: return launch<T, 64>(q, k, v, st, a, ctx_k, s);
    case 128: return launch<T, 128>(q, k, v, st, a, ctx_k, s);
    default: return cudaErrorInvalidValue;
  }
}

// registers, local (spilled) bytes, dynamic shared memory, resident thread
// blocks an SM and ring slots of one instantiation
template <typename T, int HS>
cudaError_t info_of(int* info) {
  auto kernel = bst_attn_fwd_wgmma_kernel<T, HS>;
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

}  // namespace

// dtype 1 = bfloat16, 2 = float16; hs 64 or 128; block size 64; anything
// else returns cudaErrorInvalidValue.  q (batch, ctx_q, heads * hs), k and
// v (batch, ctx_k, heads * hs) through strides {q batch, q row, k batch,
// k row, v batch, v row} (elements); out contiguous like q; lse (batch,
// heads, ctx_q) f32 or null.  pair_rows (lut_heads, P, 2), pair_ptr
// (lut_heads * (P + 1)) and pair_ent (n, 4), 16-byte aligned: pair_plan's
// arrays over the query-row CSR, P = ceil(ctx_blks_q / 2); uniq the
// (n_uniq * 64, 64) int8 mask table.  q, k and v start on 16 bytes with
// batch and row strides that are multiples of 8 elements.  Returns a
// cudaError_t (0 = launched).
extern "C" int bst_attn_fwd_wgmma(int dtype, int hs, const void* q, const void* k,
                                  const void* v, void* out, void* lse_out,
                                  const long long* strides, const int* pair_rows,
                                  const int* pair_ptr, const int* pair_ent,
                                  const signed char* uniq, int batch, int heads, int lut_heads,
                                  int ctx_blks_q, int ctx_blks_k, float scale, void* stream) {
  const int pairs = (ctx_blks_q + 1) / 2;
  const long long items = (long long)pairs * batch * heads;
  if (batch < 0 || ctx_blks_q < 0 || items > 0x7fffffff) return cudaErrorInvalidValue;
  const FwdArgs a{out, static_cast<float*>(lse_out), pair_rows, pair_ptr,
                  reinterpret_cast<const int4*>(pair_ent), uniq, batch, heads, lut_heads,
                  ctx_blks_q, pairs, static_cast<int>(items), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctx_k = ctx_blks_k * BS;
  if (dtype == 1) return dispatch<__nv_bfloat16>(hs, q, k, v, strides, a, ctx_k, s);
  if (dtype == 2) return dispatch<__half>(hs, q, k, v, strides, a, ctx_k, s);
  return cudaErrorInvalidValue;
}

// info[0..4] of the instantiation for dtype (1 bf16, 2 f16) and hs (64,
// 128): registers, local bytes, dynamic shared memory, resident thread
// blocks an SM, ring slots.  Returns a cudaError_t.
extern "C" int bst_attn_fwd_wgmma_info(int dtype, int hs, int* info) {
  if (hs != 64 && hs != 128) return cudaErrorInvalidValue;
  if (dtype == 1) return hs == 64 ? info_of<__nv_bfloat16, 64>(info)
                                  : info_of<__nv_bfloat16, 128>(info);
  if (dtype == 2) return hs == 64 ? info_of<__half, 64>(info) : info_of<__half, 128>(info);
  return cudaErrorInvalidValue;
}
