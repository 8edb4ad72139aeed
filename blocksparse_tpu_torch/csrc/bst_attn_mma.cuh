// What the two tensor-core attention sources share (bst_attn_fwd_mma.cu,
// the forward; bst_attn_bwd_mma.cu, dq and dk/dv): a thread block of
// BS / 16 warps, each owning 16 rows of its block-row; a ring of
// stages<HS>() shared-memory slots filled by cp.async; (BS, HS) tiles in
// shared-memory rows of HS + 8 elements (16 bytes of padding, so the eight
// row addresses of an ldmatrix fall in distinct banks); and the products
// on mma.sync.m16n8k16, A fragments from registers, B by ldmatrix.
#pragma once

#include "bst_attn.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// BS / 16 warps, each owning 16 rows of the block-row; the backward forms
// S (S^T) CW columns at a time, which bounds the registers it takes.
template <int BS> struct Cfg {
  static constexpr int WARPS = BS / 16, THREADS = 32 * WARPS;
  static constexpr int CW = BS < 32 ? BS : 32;
};
// Slots of the ring: 3, or 2 at hs 128, where a slot is twice as large.
template <int HS> __host__ __device__ constexpr int stages() { return HS >= 128 ? 2 : 3; }

// cp.async of a (BS, HS) block whose rows lie row_stride elements apart
// into shared-memory rows of HS + 8.
template <int BS, int HS, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long row_stride) {
  constexpr int RCH = HS / 8, THREADS = Cfg<BS>::THREADS;
#pragma unroll
  for (int i = 0; i < BS * RCH / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS, r = c / RCH, k = c % RCH;
    cp_async16(smem_addr(dst + r * (HS + 8) + k * 8), src + r * row_stride + k * 8, true);
  }
}

// The A fragments of rows r0 .. r0 + 15 of a staged (., HS) tile.
template <int HS, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[HS / 16][4], const T* tile, int r0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    ldsm_x4(a[kk], smem_addr(tile + (r0 + (lane & 15)) * (HS + 8) + kk * 16 + (lane >> 4) * 8));
}

// acc (16 x CW) += a (16 x HS) . tile[c0 : c0 + CW]^T: the tile's rows are
// the product's columns, read by plain ldmatrix.
template <int HS, int CW, typename T>
__device__ __forceinline__ void mma_nt(float (&acc)[CW / 8][4], const uint32_t (&a)[HS / 16][4],
                                       const T* tile, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
#pragma unroll
    for (int np = 0; np < CW / 8; np += 2) {
      // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
      uint32_t r[4];
      ldsm_x4(r, smem_addr(tile + (c0 + np * 8 + (lane >> 4) * 8 + (lane & 7)) * (HS + 8) +
                           kk * 16 + ((lane >> 3) & 1) * 8));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma(acc[np], a[kk], b0, T());
      mma(acc[np + 1], a[kk], b1, T());
    }
}

// acc (16 x HS) += a (16 x 16 KC) . tile[c0 : c0 + 16 KC]: the tile's rows
// are the contraction, read by ldmatrix.trans.
template <int HS, int KC, typename T>
__device__ __forceinline__ void mma_nn(float (&acc)[HS / 8][4], const uint32_t (&a)[KC][4],
                                       const T* tile, int c0, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int np = 0; np < HS / 8; np += 2) {
      // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t r[4];
      ldsm_x4_t(r, smem_addr(tile + (c0 + kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                        (HS + 8) +
                             np * 8 + (lane >> 4) * 8));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma(acc[np], a[kc], b0, T());
      mma(acc[np + 1], a[kc], b1, T());
    }
}

// The f32 accumulators of a 16 x 16 KC result as the A fragments of the
// next product's left operand, each pair rounded once to T (FlashAttention-2's
// register reuse: an n8 tile pair's c0..c3 are one k16 step's a0..a3).
template <int KC, typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[KC][4], const float (&c)[2 * KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack2(c[2 * kc][0], c[2 * kc][1], T());
    a[kc][1] = pack2(c[2 * kc][2], c[2 * kc][3], T());
    a[kc][2] = pack2(c[2 * kc + 1][0], c[2 * kc + 1][1], T());
    a[kc][3] = pack2(c[2 * kc + 1][2], c[2 * kc + 1][3], T());
  }
}

}  // namespace
