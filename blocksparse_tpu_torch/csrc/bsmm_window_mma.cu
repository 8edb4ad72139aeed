// Block-sparse matmul xprop with x staged once per window slab, on Hopper's
// tensor cores, bf16 and f16, NC orientation (feature_axis=1), b 8-128:
//   fprop  y  (N, K) = x  (N, C) . W,    over the layout's blocks;
//   bprop  dx (N, C) = dy (N, K) . W^T,  over the same blocks (TRANS).
//
// Replaces, for bf16 and f16 inputs, the TPU kernel xprop_pallas_window
// (blocksparse_tpu/kernels/bsmm.py, body _xprop_window_kernel): a
// super-group of output columns keeps its f32 accumulators resident while x
// is streamed once per column window.  f32 inputs stay on bsmm_window.cu,
// exact on the CUDA cores.  The plan is bsmm_window.cu's (kernels/bsmm.py
// window_plan): ptr[(sg * nwin + win) * SG + lo] .. ptr[... + 1] are the
// entries (slot within the window, weight block) of output column sg * SG
// + lo in window win, in LUT order; a super-group's entries over all its
// windows are one contiguous run, window by window.
//
// Design: one thread block owns one (N-tile of TN rows, super-group sg of SG
// output columns).  Eight warps; each owns CPW whole output columns of the
// super-group (b8: two) or a 32-wide slice of one (b64: half, b128: a
// quarter), all TN rows: its TN x NW f32 accumulators stay in registers for
// the whole call, indexed by constants only (TN * SG * B / 256 a thread,
// at most 128).  The block walks its entries in stages: a stage is up to EC
// consecutive entries of one window (EC * B * B * 2 bytes of W, about 32
// KB).  A stage that opens a window also copies the window's x slab (TN
// rows x 256 columns) into one of two slab buffers; the W blocks of the
// stage go into one of two ring slots, as stored.  All copies are 16-byte
// cp.async, rows past N and columns past C zero-filled (src-size 0).  The
// next stage (and, when it opens a window, the next slab) is in flight
// while the warps run this one's mma; one barrier a stage.  A stage's
// indices (its slots, weight blocks and the window's column offsets) come
// into shared memory by 4-byte cp.async two stages ahead, so neither the
// copies nor the mma wait on a dependent read of device memory.  Each warp runs
// the entries of its own column(s) in the stage: A fragments (x) by
// ldmatrix from the slab at the entry's slot, B fragments by
// ldmatrix.trans in fprop (W as stored is (k, n)) and plain ldmatrix in
// bprop (W as stored is (n, k)), mma.sync m16n8k16.  b8 pairs two entries
// in one k16 step (ldmatrix takes each lane's row address, so the two
// halves of the A and B fragments come from two slots); an odd last entry
// pairs with zeros (the slab's zeroed pad columns and a zeroed W block).
// Each output is written once, rounded once; an empty column writes zeros.
// No atomics: each output's sum runs entry by entry in LUT order, k16 step
// by k16 step, so two runs give identical bits (not bsmm_fprop.cu's order:
// in bf16 and f16 the result equals the unsplit kernel's within rounding).
//
// TN is the host's (kernels/bsmm.py window_tn): the largest of 128, 64, 32
// and 16 whose grid, ceil(N / TN) x ceil(n_out / SG) thread blocks, fills
// the card's SMs (16 if none does).
//
// Bound and byte model on the H100: at the window's regime (random 8192^2,
// b32, d 0.25, 16,784 blocks, SG * B = 256 output columns, every window
// holding entries) x is read ceil(n_out / SG) * N * C * 2 bytes (32
// super-groups: 134 MB at N 256, 1.07 GB at N 2048) and W (34.4 MB) once per
// N-tile (TN 32 at N 256: 275 MB; TN 128 at N 2048: 550 MB), through L2;
// the tensor-core work is 8.8 / 70 GFLOP.  The least bytes (inputs once,
// output once) are 43 / 101 MB: bound by bytes; what this design spends
// beyond that is the slab re-read per super-group and W per N-tile.
#include "mma_sm90.cuh"

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int SLAB = 256;         // x columns a window stages: WB = SLAB / B block-rows
constexpr int XLD = SLAB + 8;     // padded slab row (b8 reads the pad, zeroed, as an empty slot)
constexpr int EC_BYTES = 32768;   // W bytes a ring stage holds, at most (at least one block)

template <int B> struct WinSG;
template <> struct WinSG<8>   { static constexpr int value = 16; };
template <> struct WinSG<16>  { static constexpr int value = 8; };
template <> struct WinSG<32>  { static constexpr int value = 8; };
template <> struct WinSG<64>  { static constexpr int value = 4; };
template <> struct WinSG<128> { static constexpr int value = 2; };

template <int B> struct WinShape {
  static constexpr int SG = WinSG<B>::value;          // output columns a super-group
  static constexpr int CPW = SG > WARPS ? SG / WARPS : 1;  // whole columns a warp
  static constexpr int WPC = SG < WARPS ? WARPS / SG : 1;  // warps a column
  static constexpr int NW = B / WPC;                  // a warp's columns of a block
  static constexpr int NT = NW / 8;                   // its n8 tiles
  static constexpr int WB = SLAB / B;
  static constexpr int WP = B == 8 ? B : B + 8;       // padded W row (b8's rows are 16 bytes)
  static constexpr int EC_FIT = EC_BYTES / (B * WP * 2);
  static constexpr int EC = EC_FIT < 1 ? 1 : (EC_FIT < SG * WB ? EC_FIT : SG * WB);
  static constexpr int W_ELEMS = EC * B * WP;         // one ring slot
  // a stage's indices: EC slots, EC weight blocks, the window's SG + 1
  // column offsets
  static constexpr int META = 2 * EC + SG + 1;
};

template <typename T, int B, int TN>
constexpr size_t smem_bytes() {
  using S = WinShape<B>;
  return sizeof(T) * (2 * (size_t)TN * XLD + 2 * (size_t)S::W_ELEMS + 64) +
         sizeof(int) * 3 * S::META;
}

template <typename T, int B, int TN, bool TRANS>
__global__ void __launch_bounds__(THREADS)
bsmm_window_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ ptr, const int* __restrict__ ent_slot,
                       const int* __restrict__ ent_w, T* __restrict__ y, int N, int C, int K,
                       int nwin) {
  using S = WinShape<B>;
  constexpr int SG = S::SG, CPW = S::CPW, WPC = S::WPC, NW = S::NW, NT = S::NT;
  constexpr int WP = S::WP, EC = S::EC, MT = TN / 16;
  constexpr int SLAB_ELEMS = TN * XLD;
  constexpr int BCH = B / 8;                 // 16-byte chunks of a W row
  constexpr int ECH = B * BCH;               // 16-byte chunks of a W block
  static_assert(NT == 1 || NT % 2 == 0, "n8 tiles are loaded in pairs");
  static_assert(B != 8 || (NT == 1 && WPC == 1), "b8 pairs entries of whole columns");
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);      // [2][TN][XLD]
  T* wring = slab + 2 * SLAB_ELEMS;          // [2][EC][B][WP], W as stored
  T* wzero = wring + 2 * S::W_ELEMS;         // an 8 x 8 block of zeros (b8)
  int* meta = reinterpret_cast<int*>(wzero + 64);  // [3][META]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TN;
  const int sg = blockIdx.y;
  const int col0 = (warp / WPC) * CPW;       // the warp's first local column
  const int nw0 = (warp % WPC) * NW;         // its first column within the block
  const int* sp = ptr + (size_t)sg * nwin * SG;  // sp[win * SG + lo]

  if constexpr (B == 8) {
    // b8's empty slot: the slabs' pad columns and one W block, zero
    for (int l = tid; l < 2 * TN; l += THREADS)
      *reinterpret_cast<uint4*>(slab + l * XLD + SLAB) = make_uint4(0, 0, 0, 0);
    if (tid < 8) *reinterpret_cast<uint4*>(wzero + tid * 8) = make_uint4(0, 0, 0, 0);
  }

  // A stage: entries [a, b) of window win (its entries end at `end`); kw
  // counts the windows opened before it (its slab buffer is kw & 1).
  struct Stage { int win, kw, a, b, end; };
  auto window_from = [&](int win, int kw) {
    for (; win < nwin; ++win) {
      const int a = __ldg(sp + win * SG), e = __ldg(sp + win * SG + SG);
      if (a < e) return Stage{win, kw, a, min(a + EC, e), e};
    }
    return Stage{nwin, kw, 0, 0, 0};
  };
  auto next = [&](const Stage& s) {
    if (s.win >= nwin) return s;
    if (s.b < s.end) return Stage{s.win, s.kw, s.b, min(s.b + EC, s.end), s.end};
    return window_from(s.win + 1, s.kw + 1);
  };

  // A stage's indices into meta slot m, two stages ahead of its mma, so
  // that neither its copies nor its mma wait on a read of device memory.
  auto load_meta = [&](const Stage& st, int m) {
    int* mp = meta + m * S::META;
    for (int k = tid; k < st.b - st.a; k += THREADS) {
      cp_async4(smem_addr(mp + k), ent_slot + st.a + k);
      cp_async4(smem_addr(mp + EC + k), ent_w + st.a + k);
    }
    if (tid <= SG) cp_async4(smem_addr(mp + 2 * EC + tid), sp + st.win * SG + tid);
  };

  // A stage's W blocks into ring slot `ring`, and the slab of its window
  // if it opens one; its indices are in meta slot m.
  auto load = [&](const Stage& st, int ring, int m, bool with_slab) {
    if (with_slab) {
      T* xs = slab + (st.kw & 1) * SLAB_ELEMS;
      const int c0 = st.win * SLAB;
      constexpr int RCH = SLAB / 8;
      static_assert((TN * RCH) % THREADS == 0, "slab staging");
#pragma unroll
      for (int i = 0; i < TN * RCH / THREADS; ++i) {
        const int l = tid + i * THREADS;
        const int m_ = l / RCH, q = l % RCH;
        const int c = c0 + q * 8;
        const bool v = n0 + m_ < N && c < C;
        cp_async16(smem_addr(xs + m_ * XLD + q * 8), v ? x + (size_t)(n0 + m_) * C + c : x, v);
      }
    }
    T* ws = wring + ring * S::W_ELEMS;
    const int* mw = meta + m * S::META + EC;
    const int n_ch = (st.b - st.a) * ECH;
#pragma unroll
    for (int i = 0; i < (EC * ECH + THREADS - 1) / THREADS; ++i) {
      const int l = tid + i * THREADS;
      if (l < n_ch) {
        const int k = l / ECH, r = (l % ECH) / BCH, q = l % BCH;
        cp_async16(smem_addr(ws + (k * B + r) * WP + q * 8),
                   w + (size_t)mw[k] * B * B + r * B + q * 8, true);
      }
    }
  };

  float acc[CPW][MT][NT][4];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][mt][nt][r] = 0.f;

  // The mma of one stage: each warp runs the stage's entries of its columns.
  auto compute = [&](const Stage& st, int ring, int m) {
    const T* xs = slab + (st.kw & 1) * SLAB_ELEMS;
    const T* ws = wring + ring * S::W_ELEMS;
    const int* ss = meta + m * S::META;
    const int* wp = ss + 2 * EC;
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int lo = col0 + c;
      const int e0 = max(wp[lo], st.a) - st.a;
      const int e1 = min(wp[lo + 1], st.b) - st.a;
      if constexpr (B == 8) {
        for (int e = e0; e < e1; e += 2) {
          // k 0-7 from entry e, k 8-15 from entry e + 1 or zeros
          const bool two = e + 1 < e1;
          const int xcol = (lane >> 4) ? (two ? ss[e + 1] * 8 : SLAB) : ss[e] * 8;
          const T* wb = ((lane >> 3) & 1) ? (two ? ws + (e + 1) * 64 : wzero) : ws + e * 64;
          uint32_t b[2];
          if constexpr (TRANS)
            ldsm_x2(b, smem_addr(wb + (lane & 7) * 8));
          else
            ldsm_x2_t(b, smem_addr(wb + (lane & 7) * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldsm_x4(a, smem_addr(xs + (mt * 16 + (lane & 15)) * XLD + xcol));
            mma(acc[c][mt][0], a, b, T());
          }
        }
      } else {
        for (int e = e0; e < e1; ++e) {
          const T* xe = xs + ss[e] * B;
          const T* we = ws + e * B * WP;
#pragma unroll
          for (int kk = 0; kk < B; kk += 16) {
            uint32_t b[NT][2];
#pragma unroll
            for (int np = 0; np < NT; np += 2) {
              // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
              uint32_t r[4];
              const int n = nw0 + np * 8 + (lane >> 4) * 8;
              const int k = kk + ((lane >> 3) & 1) * 8;
              if constexpr (TRANS)
                ldsm_x4(r, smem_addr(we + (n + (lane & 7)) * WP + k));
              else
                ldsm_x4_t(r, smem_addr(we + (k + (lane & 7)) * WP + n));
              b[np][0] = r[0];
              b[np][1] = r[1];
              b[np + 1][0] = r[2];
              b[np + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a[4];
              ldsm_x4(a, smem_addr(xe + (mt * 16 + (lane & 15)) * XLD + kk + (lane >> 4) * 8));
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma(acc[c][mt][nt], a, b[nt], T());
            }
          }
        }
      }
    }
  };

  Stage cur = window_from(0, 0);
  if (cur.win < nwin) {
    Stage nxt = next(cur);
    load_meta(cur, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    load(cur, 0, 0, true);
    if (nxt.win < nwin) load_meta(nxt, 1);
    cp_async_commit();
    for (int s = 0; cur.win < nwin; ++s) {
      const Stage after = next(nxt);
      cp_async_wait<0>();
      // stage s and the indices of stage s + 1 landed; every warp is done
      // with stage s - 1, whose ring slot (and, if it closed a window,
      // whose slab buffer) stage s + 1 reuses, and whose meta slot stage
      // s + 2 reuses
      __syncthreads();
      if (nxt.win < nwin) load(nxt, (s + 1) & 1, (s + 1) % 3, nxt.kw != cur.kw);
      if (after.win < nwin) load_meta(after, (s + 2) % 3);
      cp_async_commit();
      compute(cur, s & 1, s % 3);
      cur = nxt;
      nxt = after;
    }
  }
  cp_async_wait<0>();

  // epilogue: straight from the registers, two outputs a store
  const int n_out = K / B, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const int o = sg * SG + col0 + c;
    if (o >= n_out) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = n0 + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        T* yp = y + (size_t)r * K + (size_t)o * B + nw0 + nt * 8 + tg * 2;
        if (r < N) store2(yp, acc[c][mt][nt][0], acc[c][mt][nt][1]);
        if (r + 8 < N) store2(yp + (size_t)8 * K, acc[c][mt][nt][2], acc[c][mt][nt][3]);
      }
    }
  }
}

template <typename T, int B, int TN, bool TRANS>
cudaError_t launch_one(const void* x, const void* w, const int* ptr, const int* ent_slot,
                       const int* ent_w, void* y, int N, int C, int K, cudaStream_t stream) {
  auto kernel = bsmm_window_mma_kernel<T, B, TN, TRANS>;
  constexpr size_t bytes = smem_bytes<T, B, TN>();
  static_assert(bytes <= 232448, "shared memory of one thread block");
  static unsigned ready = 0;
  cudaError_t err = opt_in_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  constexpr int SG = WinShape<B>::SG;
  const int n_out = K / B;
  const int nwin = (C + SLAB - 1) / SLAB;
  dim3 grid((N + TN - 1) / TN, (n_out + SG - 1) / SG);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           ptr, ent_slot, ent_w, static_cast<T*>(y), N, C, K,
                                           nwin);
  return cudaGetLastError();
}

#define WIN_ARGS x, w, ptr, ent_slot, ent_w, y, N, C, K, s

template <typename T, int B, int TN>
cudaError_t launch_dir(int trans_w, const void* x, const void* w, const int* ptr,
                       const int* ent_slot, const int* ent_w, void* y, int N, int C, int K,
                       cudaStream_t s) {
  return trans_w ? launch_one<T, B, TN, true>(WIN_ARGS)
                 : launch_one<T, B, TN, false>(WIN_ARGS);
}

template <typename T, int B>
cudaError_t launch_tn(int tn, int trans_w, const void* x, const void* w, const int* ptr,
                      const int* ent_slot, const int* ent_w, void* y, int N, int C, int K,
                      cudaStream_t s) {
  switch (tn) {
    case 16: return launch_dir<T, B, 16>(trans_w, WIN_ARGS);
    case 32: return launch_dir<T, B, 32>(trans_w, WIN_ARGS);
    case 64: return launch_dir<T, B, 64>(trans_w, WIN_ARGS);
    case 128: return launch_dir<T, B, 128>(trans_w, WIN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int bsize, int tn, int trans_w, const void* x, const void* w,
                     const int* ptr, const int* ent_slot, const int* ent_w, void* y, int N,
                     int C, int K, cudaStream_t s) {
  switch (bsize) {
    case 8: return launch_tn<T, 8>(tn, trans_w, WIN_ARGS);
    case 16: return launch_tn<T, 16>(tn, trans_w, WIN_ARGS);
    case 32: return launch_tn<T, 32>(tn, trans_w, WIN_ARGS);
    case 64: return launch_tn<T, 64>(tn, trans_w, WIN_ARGS);
    case 128: return launch_tn<T, 128>(tn, trans_w, WIN_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bsmm_window.cu's interface for bf16 (dtype 1) and f16 (dtype 2), with the
// N-tile tn (16, 32, 64 or 128) last before the stream; any other dtype or
// tn returns cudaErrorInvalidValue.  x is (N, C), y (N, K); trans_w = 0 for
// fprop (W[w] is (in, out)), 1 for bprop (W[w]^T).  ptr holds ceil(K /
// bsize / SG) * ceil(C / 256) * SG + 1 offsets.  x and w must be 16-byte
// aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bsmm_window_mma_nc(int dtype, int bsize, int trans_w, const void* x,
                                  const void* w, const int* ptr, const int* ent_slot,
                                  const int* ent_w, void* y, int N, int C, int K, int tn,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bsize, tn, trans_w, WIN_ARGS);
  if (dtype == 2) return dispatch<__half>(bsize, tn, trans_w, WIN_ARGS);
  return cudaErrorInvalidValue;
}
