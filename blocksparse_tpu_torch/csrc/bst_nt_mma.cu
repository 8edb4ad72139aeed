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
// Design: one thread block per (query block-row r, batch*head).  The nt
// list is row-sorted, so row r's blocks are the entries row_ptr[r] ..
// row_ptr[r+1] of its layout head.  The block stages its query block (B
// rows of hs, b8 padded to one m16 of zero rows) once, then walks the row
// in stages of KN = 64 key rows: E = 64 / B entries' key blocks stacked, so
// one stage is a (B x hs) . (hs x 64) product whatever the block size,
// E score blocks side by side.  A stage is one 16-byte cp.async a thread
// and row chunk, zero-filled past the row's last entry and past hs (hs a
// multiple of 8, padded to k16); a two-slot ring loads the next stage while
// the warps run this one's hs/16 k16 steps.  Four warps split the (max(B,
// 16) x 64) tile: B/16 strips of 16 rows, the rest of the warps along the
// 64 columns; mma.sync m16n8k16 with f32 accumulators, q's fragments by
// ldmatrix, k's by plain ldmatrix (k rows are the product's n).  Each score
// is one sum over hs in k16 order, rounded once: two runs give equal bits.
//
// Bound on the H100: at the LM's check shape (batch 8, ctx 2048, B 64, 312
// blocks, 2 heads of 256) a call writes 8 * 2 * 312 * 64^2 * 2 B = 40.9 MB
// of scores and reads q and k (2 x 16.8 MB): 74.4 MB, 22 us at 3.35 TB/s,
// against 10.5 GFLOP, 11 us of bf16 tensor-core work: bound by bytes.  The
// design reads each key block once per entry (from L2: k is 16.8 MB) and
// writes each score once; the 4-byte fragment stores are what it spends
// beyond the bound.
#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS, STAGES = 2;
constexpr int KN = 64;          // key rows a stage: E = KN / B entries
constexpr int MAX_HS = 512;     // the wrapper's NT_MAX_HEAD_SIZE

__host__ __device__ constexpr int row_ld(int hs) { return ((hs + 15) & ~15) + 8; }

template <int B> struct NtShape {
  static constexpr int E = KN / B;          // entries a stage
  static constexpr int MP = B < 16 ? 16 : B;  // query rows staged (b8: one m16)
  static constexpr int WM = MP / 16;        // warps along the rows
  static constexpr int WN = WARPS / WM;     // warps along the 64 columns
  static constexpr int NT = KN / 8 / WN;    // a warp's n8 tiles
};

template <typename T, int B>
size_t smem_bytes(int hs) {
  return static_cast<size_t>(NtShape<B>::MP + STAGES * KN) * row_ld(hs) * sizeof(T);
}

template <typename T, int B>
__global__ void __launch_bounds__(THREADS)
bst_nt_mma_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ w,
                  long long sa_b, long long sa_r, long long sb_b, long long sb_r,
                  const int* __restrict__ row_ptr, const int* __restrict__ ent_k, int hs,
                  int heads, int lut_heads, int rows, int blocks) {
  using S = NtShape<B>;
  static_assert(S::NT % 2 == 0, "n8 tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = row_ld(hs), hsp = ld - 8, chunks = hsp / 8;
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + S::MP * ld;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int r = blockIdx.x, nh = blockIdx.y;
  const int n = nh / heads, h = nh % heads;
  const int lh = lut_heads == 1 ? 0 : h;
  const int e0 = row_ptr[lh * (rows + 1) + r];
  const int cnt = row_ptr[lh * (rows + 1) + r + 1] - e0;
  if (cnt == 0) return;
  const int* ek = ent_k + static_cast<size_t>(lh) * blocks + e0;
  const T* abase = a + n * sa_b + static_cast<size_t>(h) * hs;
  const T* bbase = b + n * sb_b + static_cast<size_t>(h) * hs;
  const int stages = (cnt + S::E - 1) / S::E;

  // the query block: rows past B and columns past hs zero
  for (int c = tid; c < S::MP * chunks; c += THREADS) {
    const int m = c / chunks, kc = c % chunks;
    const bool v = m < B && kc * 8 < hs;
    cp_async16(smem_addr(qs + m * ld + kc * 8),
               v ? abase + static_cast<size_t>(r * B + m) * sa_r + kc * 8 : a, v);
  }
  // stage s: the key blocks of entries s*E .. s*E + E - 1, stacked
  auto load = [&](int s, int slot) {
    T* dst = ring + slot * KN * ld;
    for (int c = tid; c < KN * chunks; c += THREADS) {
      const int row = c / chunks, kc = c % chunks;
      const int e = s * S::E + row / B;
      const bool v = e < cnt && kc * 8 < hs;
      const T* src = a;
      if (v) src = bbase + (static_cast<size_t>(__ldg(ek + e)) * B + row % B) * sb_r + kc * 8;
      cp_async16(smem_addr(dst + row * ld + kc * 8), src, v);
    }
  };

  load(0, 0);
  cp_async_commit();
  const int g = lane >> 2, tg = lane & 3;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s (and the query block) landed; slot (s+1)%2 is free
    if (s + 1 < stages) load(s + 1, (s + 1) % STAGES);
    cp_async_commit();

    const T* ks = ring + (s % STAGES) * KN * ld;
    float acc[S::NT][4];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    const int nbase = wn * S::NT * 8;
    for (int kk = 0; kk < hsp; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, smem_addr(qs + (wm * 16 + (lane & 15)) * ld + kk + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < S::NT; np += 2) {
        // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        uint32_t rr[4];
        ldsm_x4(rr, smem_addr(ks + (nbase + np * 8 + (lane >> 4) * 8 + (lane & 7)) * ld + kk +
                              ((lane >> 3) & 1) * 8));
        const uint32_t b0[2] = {rr[0], rr[1]}, b1[2] = {rr[2], rr[3]};
        mma(acc[np], af, b0, T());
        mma(acc[np + 1], af, b1, T());
      }
    }
    // each n8 tile lies in one entry's score block
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) {
      const int col = nbase + nt * 8 + tg * 2;
      const int e = s * S::E + col / B, jc = col % B;
      if (e >= cnt) continue;
      T* dst = w + (static_cast<size_t>(nh) * blocks + e0 + e) * B * B + jc;
      const int i0 = wm * 16 + g;
      if (i0 < B) store2(dst + i0 * B, acc[nt][0], acc[nt][1]);
      if (i0 + 8 < B) store2(dst + (i0 + 8) * B, acc[nt][2], acc[nt][3]);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int B>
cudaError_t launch(const void* a, const void* b, void* w, const long long* st,
                   const int* row_ptr, const int* ent_k, int hs, int batch, int heads,
                   int lut_heads, int rows, int blocks, cudaStream_t stream) {
  auto kernel = bst_nt_mma_kernel<T, B>;
  static unsigned ready = 0;
  // opted in once at the largest head size the kernel takes
  cudaError_t err = opt_in_smem(kernel, smem_bytes<T, B>(MAX_HS), ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, batch * heads);
  kernel<<<grid, THREADS, smem_bytes<T, B>(hs), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(w), st[0], st[1],
      st[2], st[3], row_ptr, ent_k, hs, heads, lut_heads, rows, blocks);
  return cudaGetLastError();
}

#define NT_ARGS a, b, w, strides, row_ptr, ent_k, hs, batch, heads, lut_heads, rows, blocks, s

template <typename T>
cudaError_t dispatch(int bsize, const void* a, const void* b, void* w, const long long* strides,
                     const int* row_ptr, const int* ent_k, int hs, int batch, int heads,
                     int lut_heads, int rows, int blocks, cudaStream_t s) {
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
// query-row CSR (row_ptr (lut_heads, rows + 1), ent_k (lut_heads, blocks):
// entry e of a layout head is its block e, ent_k[e] its key block), bf16
// (dtype 1) or f16 (dtype 2); any other dtype, block size or a head size
// that is not a multiple of 8 up to 512 returns cudaErrorInvalidValue.
// strides: a's batch and row strides, then b's, in elements; a, b 16-byte
// aligned with strides multiples of 8.  Returns a cudaError_t (0 = launched).
extern "C" int bst_nt_mma(int dtype, int bsize, int hs, const void* a, const void* b, void* w,
                          const long long* strides, const int* row_ptr, const int* ent_k,
                          int batch, int heads, int lut_heads, int rows, int blocks,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs <= 0 || hs % 8 || hs > MAX_HS) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, NT_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, NT_ARGS);
  return cudaErrorInvalidValue;
}
