// The unfused block-sparse attention's scores on Hopper's tensor cores, bf16
// and f16 (the NT product of BlocksparseTransformer.nt_op):
//   w[n, h, e] = a_blk(q_e) . b_blk(k_e)^T over the head size hs,
// for every layout block e of the instance's layout head, rounded once to
// the input type.  a (batch, ctx_q, heads*hs) and b (batch, ctx_k,
// heads*hs) are read in place through their batch and row strides (the
// column slices of a packed qkv go in as they are); w is (batch, heads,
// blocks, B, B), contiguous.
//
// Replaces, for bf16 and f16 inputs, the TPU kernel updat_pallas_dense_tile
// (blocksparse_tpu/kernels/bsmm.py) in its _nt_impl_pallas use
// (blocksparse_tpu/ops/transformer.py), vmapped there over batch*heads with
// q as x and k as dy.  f32 inputs run bst_nt.cu, exact on the CUDA cores.
//
// Bound on the H100: at the LM's check shape (batch 8, ctx 2048, B 64, 312
// blocks, 2 heads of 256) a call writes 8 * 2 * 312 * 64^2 * 2 B = 40.9 MB
// of scores and reads q and k (2 x 16.8 MB): 74.4 MB, 22 us at 3.35 TB/s,
// against 10.5 GFLOP, 11 us of bf16 tensor-core work: bound by bytes.
// Beyond that, each entry reads its key block (64 x hs) once from L2: 164
// MB through L2 at the check shape, the design's floor.
//
// Design: one thread block (one warpgroup) per (plan item, batch*head).
// The launch plan (trio_tables' plan: the CSR's row pointers, then each
// layout head's items) lists the query rows longest first, a row far
// longer than the mean cut into two halves (items row*4 + part: part 0
// the whole row, 1 its first ceil(count/2) entries, 2 the rest; -1 no
// item).  No sum crosses entries, so each half writes its own score
// blocks.  The block keeps its query block (B rows of hs) resident in
// shared memory and walks its entries in tiles of KN = 64 key rows: E = 64
// / B entries' key blocks stacked.  A tile is one wgmma product with the
// keys as A and the queries as B, both K-major (hs contiguous), so
// neither is transposed: D (64 key rows x B query rows, f32 in registers)
// = keys . q^T over hs in k16 steps, m64nBk16 at every block size.  q and
// k are read in place by TMA: boxes of B rows x 64 head columns (columns
// past hs arrive as zeros) land in wgmma's 128-byte swizzled layout, one
// mbarrier a slot.  The keys stream in stages of 64 key rows x KC = 64
// head columns through a four-slot ring, two stages in flight while one
// is multiplied and the one before may still be read by its last wgmma
// group; one thread issues the copies.  A finished tile is rounded once
// and transposed into a staging tile in shared memory by stmatrix.trans,
// then written as whole 16-byte runs of its contiguous score blocks.
// Each score is one sum over hs in k16 order: two runs give equal bits.
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int THREADS = 128, STAGES = 4;
constexpr int KN = 64;                   // key rows a tile: E = KN / B entries
constexpr int KC = 64;                   // head columns a stage (128 bytes a row)
constexpr int SLOT = KN * KC * 2;        // bytes of a ring slot
constexpr int OLD = KN + 8;              // staging row stride (elements)
constexpr int MAX_HS = 512;              // the wrapper's NT_MAX_HEAD_SIZE

// the epilogue's transposing stores: four (two) 8 x 8 b16 matrices of mma
// fragments, each written transposed at the eight row addresses its lanes
// give (lanes 8q .. 8q + 7 for matrix q)
__device__ __forceinline__ void stsm_x4_t(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x2_t(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n"
               ::"r"(addr), "r"(r0), "r"(r1)
               : "memory");
}

template <int B>
size_t smem_bytes(int hs) {
  const size_t chunks = (hs + KC - 1) / KC;
  // 1 KB to align the tiles to 1024 bytes; the resident q sub-tiles (B
  // rows x 128 bytes each), the ring, the staging tile, the mbarriers (a
  // slot each and the query block's)
  return 1024 + chunks * B * 128 + STAGES * SLOT + static_cast<size_t>(B) * OLD * 2 +
         (STAGES + 1) * sizeof(uint64_t);
}

template <typename T, int B>
__global__ void __launch_bounds__(THREADS)
bst_nt_mma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  T* __restrict__ w, const int* __restrict__ plan, const int* __restrict__ ent_k,
                  int hs, int heads, int lut_heads, int rows, int blocks, int items) {
  constexpr int E = KN / B, R = B / 2;  // entries a tile; accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int chunks = (hs + KC - 1) / KC;
  unsigned char* qs = smem;                     // chunk kc: B rows x 128 B
  unsigned char* ring = qs + chunks * B * 128;  // STAGES slots of 64 rows x 128 B
  T* os = reinterpret_cast<T*>(ring + STAGES * SLOT);  // B query rows x OLD
  uint64_t* full = reinterpret_cast<uint64_t*>(os + B * OLD);  // a slot each, then q's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = blockIdx.x, n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int* rp = plan + lh * (rows + 1);
  const int item = plan[lut_heads * (rows + 1) + lh * items + blockIdx.y];
  if (item < 0) return;
  const int r = item >> 2, part = item & 3;
  int eb = rp[r], ee = rp[r + 1];
  const int mid = eb + (ee - eb + 1) / 2;
  if (part == 1) ee = mid;
  if (part == 2) eb = mid;
  const int cnt = ee - eb;
  if (cnt <= 0) return;
  const int tiles = (cnt + E - 1) / E, steps = tiles * chunks;
  const int* ek = ent_k + static_cast<size_t>(lh) * blocks + eb;

  // stage s (one thread): head columns (s % chunks) * KC .. + KC of tile
  // s / chunks's key blocks, each a B-row box, stacked; columns past hs
  // arrive as zeros, rows of entries past the item's last are not loaded
  // (their scores are not stored)
  auto load = [&](int s) {
    const int slot = s % STAGES, e0 = s / chunks * E, col0 = s % chunks * KC;
    const int boxes = min(E, cnt - e0);
    mbar_expect_tx(full + slot, boxes * B * 128);
    for (int j = 0; j < boxes; ++j)
      tma_load_4d(ring + slot * SLOT + j * B * 128, &kmap, full + slot, col0, h,
                  __ldg(ek + e0 + j) * B, n);
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the query block, resident
    mbar_expect_tx(full + STAGES, chunks * B * 128);
    for (int kc = 0; kc < chunks; ++kc)
      tma_load_4d(qs + kc * B * 128, &qmap, full + STAGES, kc * KC, h, r * B, n);
    for (int s = 0; s < STAGES - 2 && s < steps; ++s) load(s);
  }

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  mbar_wait(full + STAGES, 0);
  for (int t = 0, s = 0; t < tiles; ++t) {
    for (int kc = 0; kc < chunks; ++kc, ++s) {
      // every warp's products of stage s - 2 are done (each waited for all
      // but its last group before this barrier): its slot takes stage s +
      // STAGES - 2
      __syncthreads();
      if (tid == 0 && s + STAGES - 2 < steps) load(s + STAGES - 2);
      mbar_wait(full + s % STAGES, s / STAGES & 1);
      const uint64_t da = sw128_desc(smem_addr(ring + (s % STAGES) * SLOT), false);
      const uint64_t db = sw128_desc(smem_addr(qs + kc * B * 128), false);
      // the last chunk's columns past hs are zeros on both sides
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma<0, 0>(acc, da + 2 * kk, db + 2 * kk, kc > 0 || kk > 0, T());
      wgmma_commit();
      wgmma_wait<1>();
    }
    // tile t is done: round it once and transpose it into the staging tile
    // (os[query row][key row]), then write its score blocks as 16-byte runs
    // (each block is B x B contiguous).  The previous tile's reads of the
    // staging tile ended before this tile's first barrier.
    wgmma_wait<0>();
    fence_regs(acc);
    const int q = lane >> 3, rr = lane & 7;
    if constexpr (B == 8) {
      stsm_x2_t(smem_addr(os + rr * OLD + warp * 16 + (q & 1) * 8), pack2(acc[0], acc[1], T()),
                pack2(acc[2], acc[3], T()));
    } else {
#pragma unroll
      for (int j = 0; j < B / 8; j += 2)
        stsm_x4_t(smem_addr(os + (8 * (j + (q >> 1)) + rr) * OLD + warp * 16 + (q & 1) * 8),
                  pack2(acc[4 * j], acc[4 * j + 1], T()),
                  pack2(acc[4 * j + 2], acc[4 * j + 3], T()),
                  pack2(acc[4 * j + 4], acc[4 * j + 5], T()),
                  pack2(acc[4 * j + 6], acc[4 * j + 7], T()));
    }
    __syncthreads();
    constexpr int BCH = B / 8;  // 16-byte chunks of a block row
    for (int c = tid; c < E * B * BCH; c += THREADS) {
      const int j = c / (B * BCH), i = c / BCH % B, cc = c % BCH;
      const int e = t * E + j;
      if (e < cnt)
        *reinterpret_cast<uint4*>(w + ((static_cast<size_t>(nh) * blocks + eb + e) * B + i) * B +
                                  cc * 8) = *reinterpret_cast<const uint4*>(os + i * OLD + j * B +
                                                                            cc * 8);
    }
  }
}

template <typename T, int B>
cudaError_t launch(const void* a, const void* b, void* w, const long long* st, const int* plan,
                   const int* ent_k, int hs, int batch, int heads, int lut_heads, int rows,
                   int blocks, int items, int ctx_k, cudaStream_t stream) {
  auto kernel = bst_nt_mma_kernel<T, B>;
  static unsigned ready = 0;
  // opted in once at the largest head size the kernel takes
  cudaError_t err = opt_in_smem(kernel, smem_bytes<B>(MAX_HS), ready);
  if (err != cudaSuccess) return err;
  // q and k read in place by TMA boxes of B rows x 64 head columns
  CUtensorMap qmap, kmap;
  err = head_rows_map<T>(&qmap, a, hs, heads, rows * B, batch, st[1], st[0], B);
  if (err != cudaSuccess) return err;
  err = head_rows_map<T>(&kmap, b, hs, heads, ctx_k, batch, st[3], st[2], B);
  if (err != cudaSuccess) return err;
  // batch*heads runs fastest: every instance's longest items start first
  const dim3 grid(batch * heads, items);
  kernel<<<grid, THREADS, smem_bytes<B>(hs), stream>>>(qmap, kmap, static_cast<T*>(w), plan,
                                                         ent_k, hs, heads, lut_heads, rows,
                                                         blocks, items);
  return cudaGetLastError();
}

#define NT_ARGS \
  a, b, w, strides, plan, ent_k, hs, batch, heads, lut_heads, rows, blocks, items, ctx_k, s

template <typename T>
cudaError_t dispatch(int bsize, const void* a, const void* b, void* w, const long long* strides,
                     const int* plan, const int* ent_k, int hs, int batch, int heads,
                     int lut_heads, int rows, int blocks, int items, int ctx_k, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch<T, 8>(NT_ARGS);
    case 16: return launch<T, 16>(NT_ARGS);
    case 32: return launch<T, 32>(NT_ARGS);
    case 64: return launch<T, 64>(NT_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// w (batch, heads, blocks, bsize, bsize) = the scores of a and b over the
// query-row CSR and its launch plan: plan (lut_heads * (rows + 1 + items))
// = every layout head's row pointers, then every head's `items` plan items
// (trio_tables' plan); ent_k (lut_heads, blocks): entry e of a layout head
// is its block e, ent_k[e] its key block.  a holds rows * bsize query rows,
// b ctx_k key rows.  bf16 (dtype 1) or f16 (dtype 2); any other dtype,
// block size, a head size that is not a multiple of 8 up to 512, or more
// than 65535 items returns cudaErrorInvalidValue.  strides: a's batch and
// row strides, then b's, in elements; a, b 16-byte aligned with strides
// multiples of 8 (TMA reads them).  Returns a cudaError_t (0 = launched).
extern "C" int bst_nt_mma(int dtype, int bsize, int hs, const void* a, const void* b, void* w,
                          const long long* strides, const int* plan, const int* ent_k,
                          int batch, int heads, int lut_heads, int rows, int blocks, int items,
                          int ctx_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs <= 0 || hs % 8 || hs > MAX_HS || items <= 0 || items > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, NT_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, NT_ARGS);
  return cudaErrorInvalidValue;
}
