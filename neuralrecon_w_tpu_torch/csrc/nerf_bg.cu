// K8, K9: the NeRF++ background, forward and first-order backward.
//
// Replace the TPU kernels ops/pallas_nerf_bg.py:bg_fwd_pallas (K8, its
// _bg_fwd_kernel) and bg_bwd_pallas (K9, its _bg_bwd_kernel), the custom VJP
// of TPU.FUSED_BG. The plain versions are ops/nerf_bg_fused.bg_fwd_plain and
// bg_bwd_plain. Per point: PE(pts4) (10 frequencies, 4 inputs) through the
// 8 x 256 MLP with [pe, h] into layer 5, the alpha head (density) and the
// feature head, then the appearance head on [feature | PE_view(dirs) | a]
// (app0..3, or views0 without the appearance code) and the rgb layer. K9
// recomputes that forward and runs its reverse from the cotangents on
// (density, rgb): the head, feature + alpha into the last hidden state,
// the MLP with the skip's PE part, and both PE Jacobians transposed, giving
// d_pts4, d_dirs and d_a.
//
// What bounds them: ~0.6 M weights, ~1.3 MFLOP a point forward (K8) and
// ~2.6 for K9 (the forward recomputed, then dX) against ~80 bytes of inputs
// and outputs a point, so the products bound both. K9 also leaves per layer
// its (cotangent, input) rows, ~5,900 f32 values a point, for K5
// (nw_dw_reduce, sdf_vjp.cu), which reduces them into dW: the TPU kernel
// kept every dW accumulator in VMEM, but 2.6 MB of f32 dW does not fit 227
// KB of shared memory. Those rows are K9's floor in bytes (~0.63 ms per
// 90,112 points at 3.35 TB/s).
//
// The design: the tile pass of the SDF kernels (sdf_tile.cuh). One block
// per tile of 64 points; the running operand lives in shared memory in the
// activation dtype (T), each layer's output written over its input; every
// product's weight slabs stream through one cp.async ring over a GEMM list
// built on the host (bg_sched), in the order the kernel runs its tgemms.
// The background's own config (BgCfg): 8 warps of 32 x 64 output tiles laid
// 2 x 4 over 64 x 256, so a 256-wide layer keeps every warp busy; 256-row
// ring slabs; bf16 with up to 128 registers a thread, two blocks an SM
// (K8 ~99 KB of shared memory with three ring stages, K9 ~106 KB with
// two: its mask words take the third's room); float one block an SM.
//  * pts5's input [pe (84) | h (256)] is one k-range of 352: the kernel's
//    pack of pts5 pads the PE to 96 columns with zero weights
//    (nerf_bg_fused.pack_bg_weights), and pts4's epilogue writes h from
//    operand column 96 on. The rows for K5 keep the unpadded order.
//  * The head's input [feature | PE_view | a] is one k-range too: the view
//    part sits in the operand's columns past the feature.
//  * alpha (1 column) and rgb (3) are warp dot products in K8. In K9 rgb's
//    transpose is a 16-wide product and alpha's cotangent a rank-1 term in
//    the epilogue of the feature's transpose.
//  * The transposes wider than a ring slab split in two list entries. The
//    head's: the [PE_view | a] part first (d_a out; the view PE's
//    cotangent into the operand's columns past 256), then the feature
//    part, which writes over the operand. pts5's: its h part in turn, its
//    PE part last, after layer 0's, over pts5's cotangent read back from
//    its row; both add into the PE's cotangent in the masks' room, free by
//    then. Both PE Jacobians are applied at the end, where no accumulator
//    is live: sin / cos in an epilogue spilled K9 under the 128-register
//    cap of two blocks an SM.
//  * K9's ReLU masks are bits in shared memory, in the fragment order of
//    the thread that computed them: a forward epilogue and the backward
//    epilogue of the same layer hand a thread the same (point, column)
//    pairs, so each thread reads back only its own two words a layer.
// Every GEMM operand is rounded to T, every sum and bias is f32, the masks
// come from the f32 pre-activations, and the f32 rows for K5 are written
// from the f32 values in the epilogues. Registers and spills: PERF.md
// (ptxas -v, printed by chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf_tile.cuh"

namespace {

constexpr int BG_D = 8, BG_SKIP = 4, BG_MULTIRES = 10, BG_MULTIRES_VIEW = 4, BG_DIN = 4;
constexpr int BG_DPE = BG_DIN * (1 + 2 * BG_MULTIRES);    // 84
constexpr int BG_PEPAD = 96;                              // the PE's operand columns
constexpr int BG_DVIEW = 3 * (1 + 2 * BG_MULTIRES_VIEW);  // 27
constexpr int BG_ALPHA = BG_D, BG_FEAT = BG_D + 1, BG_HEAD = BG_D + 2;
constexpr int BG_MAXL = 16;
constexpr int BG_NR = 256;   // the widest product's rows
constexpr int BG_OPW = 352;  // the widest operand row: pts5's [pe (96) | h (256)]

template <typename T, int STG> struct BgCfg;
template <int STG> struct BgCfg<bf16, STG> {
  static constexpr int P = 64, THREADS = 256, MI = 2, KS = 32, AST = BG_OPW + 8, PAD = 8;
  static constexpr int NR = BG_NR, ST = STG, MINB = 2;
};
template <int STG> struct BgCfg<float, STG> {
  static constexpr int P = 64, THREADS = 256, MI = 2, KS = 16, AST = BG_OPW + 4, PAD = 4;
  static constexpr int NR = BG_NR, ST = STG, MINB = 1;
};
template <typename T> using FwdCfg = BgCfg<T, 3>;
template <typename T> using BwdCfg = BgCfg<T, sizeof(T) == 2 ? 2 : 3>;

// layers 0 .. 7 the MLP, 8 alpha, 9 feature, 10 .. 9 + H the head, 10 + H rgb
struct Bg {
  int n_layers, n_head, n_a, W, F;
  int k[BG_MAXL], n[BG_MAXL], kpad[BG_MAXL], npad[BG_MAXL], b_off[BG_MAXL];
  long long w_off[BG_MAXL], wt_off[BG_MAXL];
};

// The tile's shared memory past the GEMM list: per point x (4), dirs (3)
// and c_density rounded to T; alpha's weight row (BG_NR f32, K9); then
// K9's mask words, two a thread for each ReLU layer (pts0..7, the head),
// whose room takes the PE's cotangent (P x BG_PEPAD f32) once the last
// mask is read. K9 keeps the view PE's cotangent in the operand's columns
// past BG_NR, which the backward's products never reach.
template <typename T, class C>
struct BgTile : Tile<T, C> {
  __device__ float* pf(int i) const {
    return reinterpret_cast<float*>(this->sm + Tile<T, C>::X_B) + i;
  }
  __device__ float* px() const { return pf(0); }
  __device__ float* pd() const { return pf(4 * C::P); }
  __device__ float* cden() const { return pf(7 * C::P); }
  __device__ float* walpha() const { return pf(8 * C::P); }
  __device__ unsigned* mask() const {
    return reinterpret_cast<unsigned*>(pf(8 * C::P + BG_NR));
  }
  __device__ float* dpe() const { return pf(8 * C::P + BG_NR); }  // P x BG_PEPAD
  // word wd of this thread's two for ReLU layer l: the bits of its
  // output pairs q (two a pair, from bit 2 q), in the order tgemm's
  // epilogue numbers them, the same in a forward epilogue and in the
  // backward's over the layer's outputs
  __device__ unsigned& mword(int l, int wd) const {
    return mask()[(l * 2 + wd) * C::THREADS + threadIdx.x];
  }
  // P x BG_DVIEW f32 at row stride DVIEW_LD
  __device__ float* dview() const { return reinterpret_cast<float*>(this->act() + BG_NR); }
  static constexpr int DVIEW_LD = C::AST * (int)sizeof(T) / 4;
};

// K8's bytes (relu_layers 0) or K9's
template <typename T, class C>
size_t bg_bytes(int relu_layers) {
  static_assert((C::AST - BG_NR) * sizeof(T) >= BG_DVIEW * sizeof(float), "the view's room");
  const size_t masks = (size_t)relu_layers * 2 * C::THREADS * sizeof(unsigned);
  const size_t dpe = relu_layers ? (size_t)C::P * BG_PEPAD * sizeof(float) : 0;
  return Tile<T, C>::X_B + ((size_t)C::P * 8 + BG_NR) * sizeof(float) +
         (masks > dpe ? masks : dpe);
}

// channel c of [v, sin(v), cos(v), sin(2v), cos(2v), ...] for a d-vector
__device__ __forceinline__ float pe_value_n(const float* v, int d, int c) {
  if (c < d) return v[c];
  const int i = (c - d) / (2 * d), r = (c - d) - 2 * d * i;
  const float f = (float)(1 << i);
  return r < d ? sinf(f * v[r]) : cosf(f * v[r - d]);
}

// (Jpe(v)^T g)_a for a D-vector v with MR frequencies
// (pallas_nerf_bg.py:_pe_transpose)
template <int D, int MR>
__device__ float pe_T_at(const float* v, const float* g, int a) {
  float s = g[a], f = 1.0f;
  for (int i = 0; i < MR; ++i, f *= 2.0f)
    s += g[D * (1 + 2 * i) + a] * f * cosf(f * v[a]) - g[D * (2 + 2 * i) + a] * f * sinf(f * v[a]);
  return s;
}

// out(p, j, sum_k act[p][k] w[j][k]) for the tile's points and j < nout,
// one warp per (p, j): the narrow heads (alpha, rgb)
template <typename T, class C, class Out>
__device__ void warp_dots(const T* act, const T* w, int ldw, int nout, int K, const Out& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < C::P * nout; e += C::THREADS / 32) {
    const int p = e / nout, j = e - p * nout;
    float s = 0.0f;
    const T* wj = w + (long long)j * ldw;
    for (int k = lane; k < K; k += 32) s += float(act[p * C::AST + k]) * float(wj[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out(p, j, s);
  }
}

// acc + b, through a ReLU if relu -> operand columns aoff + j and row
// columns roff + j; with ml >= 0 the ReLU's mask bits as ReLU layer ml
template <typename T, class C>
struct BgFwdEpi {
  static_assert(C::MI * 8 * 2 * 2 == 64, "two mask words a thread");
  BgTile<T, C> t; const float* b; float* row; int aoff, roff, n, ml; bool relu;
  __device__ void operator()(int p, int j, float a0, float a1, int q) const {
    if (j >= n) return;
    float v0 = a0 + b[j], v1 = a1 + b[j + 1];  // n is even
    if (relu) {
      if (ml >= 0)
        t.mword(ml, q >> 4) |= (unsigned)((v0 > 0.0f) | ((v1 > 0.0f) << 1)) << (2 * q & 31);
      v0 = fmaxf(v0, 0.0f), v1 = fmaxf(v1, 0.0f);
    }
    at2(t.act() + p * C::AST + aoff, j, n, v0, v1);
    if (row) st2(row + (long long)p * WMAX + roff, j, n, v0, v1);
  }
};

// r (+ c_density W_alpha[j] where alpha) through ReLU layer ml's mask (ml <
// 0: none) -> row G and the operand
template <typename T, class C>
struct BgBackEpi {
  BgTile<T, C> t; float* G; bool alpha; int ml, n;
  __device__ void operator()(int p, int j, float r0, float r1, int q) const {
    if (j >= n) return;
    if (alpha) {
      const float c = t.cden()[p];
      r0 += c * t.walpha()[j], r1 += c * t.walpha()[j + 1];
    }
    if (ml >= 0) {
      const unsigned m = t.mword(ml, q >> 4) >> (2 * q & 31);
      r0 = m & 1u ? r0 : 0.0f, r1 = m & 2u ? r1 : 0.0f;
    }
    st2(G + (long long)p * WMAX, j, n, r0, r1);
    at2(t.act() + p * C::AST, j, n, r0, r1);
  }
};

// r on column j of [g (nk) | a (n_a)]: g into dst (row stride ld; added
// where add), a's into da for the tile's real points. The PE parts of the
// transposes: their Jacobians wait for the end, where no accumulator is
// live.
struct BgRawEpi {
  float* dst; int ld, nk, n_a, n_valid; float* da; bool add;
  __device__ void one(int p, int c, float r) const {
    if (c < nk) {
      float& q = dst[p * ld + c];
      q = add ? q + r : r;
    } else if (c < nk + n_a && p < n_valid) {
      da[(long long)p * n_a + c - nk] = r;
    }
  }
  __device__ void operator()(int p, int j, float r0, float r1) const {
    one(p, j, r0);
    one(p, j + 1, r1);
  }
};

// the PE of the tile's points into operand columns 0 .. BG_PEPAD (zero past
// BG_DPE), and into rows r0 and r5 where given
template <typename T, class C>
__device__ void pe_cols(const BgTile<T, C>& t, float* r0, float* r5) {
  for (int e = threadIdx.x; e < C::P * BG_PEPAD; e += C::THREADS) {
    const int p = e / BG_PEPAD, c = e - p * BG_PEPAD;
    const float v = c < BG_DPE ? pe_value_n(t.px() + p * BG_DIN, BG_DIN, c) : 0.0f;
    t.act()[p * C::AST + c] = to_t<T>(v);
    if (r0 && c < BG_DPE) {
      r0[(long long)p * WMAX + c] = v;
      r5[(long long)p * WMAX + c] = v;
    }
  }
}

// The forward over the tile: the MLP, the alpha head (K8: density), the
// feature head, the view part [PE_view | a] past the feature, the head;
// the operand ends holding the head's output. K9 writes every layer's
// input row and the ReLU masks.
template <typename T, class C, bool K9>
__device__ void bg_forward(const Bg& bg, const T* w, const float* b, const Work& wk, long long p0,
                           Stream<T, C>& s, BgTile<T, C>& t, const float* p4, const float* dirs,
                           const float* app, int n_valid, float* density) {
  const int W = bg.W, F = bg.F;
  for (int e = threadIdx.x; e < C::P * 7; e += C::THREADS) {
    const int p = e / 7, c = e - p * 7;
    const bool ok = p < n_valid;
    if (c < BG_DIN) t.px()[p * BG_DIN + c] = ok ? p4[(long long)p * BG_DIN + c] : 0.0f;
    else t.pd()[p * 3 + c - BG_DIN] = ok ? dirs[(long long)p * 3 + c - BG_DIN] : 0.0f;
  }
  __syncthreads();
  pe_cols(t, K9 ? wk.slot(0, p0) : nullptr, K9 ? wk.slot(BG_SKIP + 1, p0) : nullptr);
  for (int l = 0; l < BG_D; ++l) {
    const bool skip = l == BG_SKIP;  // h5 lands past the PE: [pe | h5]
    auto e = [&] {
      return BgFwdEpi<T, C>{t, b + bg.b_off[l], K9 ? wk.slot(l + 1, p0) : nullptr,
                          skip ? BG_PEPAD : 0, skip ? BG_DPE : 0, W, K9 ? l : -1, true};
    };
    tgemm(s, t, t.act(), C::AST, e);
    if (skip) pe_cols(t, nullptr, nullptr);
  }
  if constexpr (!K9) {
    __syncthreads();  // h8 is in the operand
    const float ba = b[bg.b_off[BG_ALPHA]];
    warp_dots<T, C>(t.act(), w + bg.w_off[BG_ALPHA], bg.kpad[BG_ALPHA], 1, W,
                    [&](int p, int, float v) {
                      if (p < n_valid) density[p] = v + ba;
                    });
  }
  {
    auto e = [&] {
      return BgFwdEpi<T, C>{t, b + bg.b_off[BG_FEAT], K9 ? wk.slot(BG_FEAT, p0) : nullptr, 0, 0, F,
                          -1, false};
    };
    tgemm(s, t, t.act(), C::AST, e);
  }
  {  // [PE_view | a | 0] into columns F .., and the head's input row
    float* row = K9 ? wk.slot(BG_FEAT, p0) : nullptr;
    const int vw = bg.kpad[BG_HEAD] - F, n_a = bg.n_a;
    for (int e = threadIdx.x; e < C::P * vw; e += C::THREADS) {
      const int p = e / vw, c = e - p * vw;
      const float v = c < BG_DVIEW ? pe_value_n(t.pd() + p * 3, 3, c)
                    : c < BG_DVIEW + n_a && p < n_valid ? app[(long long)p * n_a + c - BG_DVIEW]
                    : 0.0f;
      t.act()[p * C::AST + F + c] = to_t<T>(v);
      if (row && c < BG_DVIEW + n_a) row[(long long)p * WMAX + F + c] = v;
    }
  }
  for (int h = 0; h < bg.n_head; ++h) {
    const int i = BG_HEAD + h;
    auto e = [&] {
      return BgFwdEpi<T, C>{t, b + bg.b_off[i], K9 ? wk.slot(i, p0) : nullptr, 0, 0, bg.n[i],
                          K9 ? BG_D + h : -1, true};
    };
    tgemm(s, t, t.act(), C::AST, e);
  }
}

// K8
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
bg_fwd_kernel(const float* __restrict__ p4, const float* __restrict__ dirs,
              const float* __restrict__ app, long long n_pts, const T* __restrict__ w,
              const float* __restrict__ b, Bg bg, Sched sched, float* __restrict__ density,
              float* __restrict__ rgb) {
  extern __shared__ __align__(16) unsigned char smem[];
  BgTile<T, C> t{{smem}};
  Stream<T, C> s = start_stream(sched, w, w, t);
  const long long p0 = (long long)blockIdx.x * C::P;
  const int n_valid = (int)min(n_pts - p0, (long long)C::P);
  bg_forward<T, C, false>(bg, w, b, Work{}, p0, s, t, p4 + p0 * BG_DIN, dirs + p0 * 3,
                          app ? app + p0 * bg.n_a : nullptr, n_valid, density + p0);
  __syncthreads();  // the head's output is in the operand
  const int l = bg.n_layers - 1;
  const float* bl = b + bg.b_off[l];
  float* out = rgb + p0 * 3;
  warp_dots<T, C>(t.act(), w + bg.w_off[l], bg.kpad[l], 3, bg.k[l], [&](int p, int j, float v) {
    if (p < n_valid) out[p * 3 + j] = v + bl[j];
  });
}

// K9
template <typename T, class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
bg_bwd_kernel(const float* __restrict__ p4, const float* __restrict__ dirs,
              const float* __restrict__ app, const float* __restrict__ cot, long long n_pts,
              const T* __restrict__ w, const float* __restrict__ b, Bg bg, Sched sched, Work wk,
              float* __restrict__ d_p4, float* __restrict__ d_dirs, float* __restrict__ d_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  BgTile<T, C> t{{smem}};
  Stream<T, C> s = start_stream(sched, w, w, t);
  const long long p0 = (long long)blockIdx.x * C::P;
  const int n_valid = (int)min(n_pts - p0, (long long)C::P);
  const int L = bg.n_layers, H = bg.n_head, W = bg.W, F = bg.F;
  auto G = [&](int i) { return wk.slot(L - 1 + i, p0); };  // layer i's cotangent row
  // each thread clears its own mask words
  for (int i = threadIdx.x; i < (BG_D + H) * 2 * C::THREADS; i += C::THREADS) t.mask()[i] = 0u;
  bg_forward<T, C, true>(bg, w, b, wk, p0, s, t, p4 + p0 * BG_DIN, dirs + p0 * 3,
                         app ? app + p0 * bg.n_a : nullptr, n_valid, nullptr);

  // the cotangents on the two linear outputs: c_density (its row; rounded,
  // for alpha's rank-1 term) and c_rgb (its row; the operand's 16 columns)
  __syncthreads();  // the head's last epilogue is done with the operand
  cot += p0 * 4;
  for (int e = threadIdx.x; e < C::P * 16; e += C::THREADS) {
    const int p = e >> 4, c = e & 15;
    const bool ok = p < n_valid;
    if (c == 0) {
      const float cd = ok ? cot[p * 4] : 0.0f;
      t.cden()[p] = rnd<T>(cd);
      G(BG_ALPHA)[(long long)p * WMAX] = cd;
    }
    const float v = c < 3 && ok ? cot[p * 4 + 1 + c] : 0.0f;
    t.act()[p * C::AST + c] = to_t<T>(v);
    if (c < 3) G(L - 1)[(long long)p * WMAX + c] = v;
  }
  const T* wa = w + bg.w_off[BG_ALPHA];
  for (int j = threadIdx.x; j < W; j += C::THREADS) t.walpha()[j] = float(wa[j]);
  // the head, g W per layer through the ReLU masks
  for (int i = L - 1; i > BG_HEAD; --i) {
    auto e = [&] { return BgBackEpi<T, C>{t, G(i - 1), false, BG_D + i - 1 - BG_HEAD, bg.k[i]}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // the head's input: [PE_view | a] first (the feature's writes over the operand)
  {
    auto e = [&] {
      return BgRawEpi{t.dview(), t.DVIEW_LD, BG_DVIEW, bg.n_a, n_valid,
                      d_a ? d_a + p0 * bg.n_a : nullptr, false};
    };
    tgemm(s, t, t.act(), C::AST, e);
  }
  {
    auto e = [&] { return BgBackEpi<T, C>{t, G(BG_FEAT), false, -1, F}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // feature + alpha join on the last hidden state
  {
    auto e = [&] { return BgBackEpi<T, C>{t, G(BG_D - 1), true, BG_D - 1, W}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // the MLP top-down (pts5 through its h part)
  for (int l = BG_D - 1; l >= 1; --l) {
    auto e = [&] { return BgBackEpi<T, C>{t, G(l - 1), false, l - 1, W}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // the PE's cotangent, into the masks' room: layer 0's, then the skip's
  // from pts5's cotangent, read back from its row
  {
    auto e = [&] { return BgRawEpi{t.dpe(), BG_PEPAD, BG_PEPAD, 0, n_valid, nullptr, false}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  {
    const float* G5 = G(BG_SKIP + 1);
    for (int e = threadIdx.x; e < C::P * W; e += C::THREADS) {
      const int p = e / W, j = e - p * W;
      t.act()[p * C::AST + j] = to_t<T>(G5[(long long)p * WMAX + j]);
    }
    auto e = [&] { return BgRawEpi{t.dpe(), BG_PEPAD, BG_PEPAD, 0, n_valid, nullptr, true}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // both PE Jacobians transposed
  __syncthreads();
  for (int e = threadIdx.x; e < n_valid * 7; e += C::THREADS) {
    const int p = e / 7, c = e - p * 7;
    if (c < BG_DIN) {
      d_p4[(p0 + p) * BG_DIN + c] =
          pe_T_at<BG_DIN, BG_MULTIRES>(t.px() + p * BG_DIN, t.dpe() + p * BG_PEPAD, c);
    } else {
      d_dirs[(p0 + p) * 3 + c - BG_DIN] = pe_T_at<3, BG_MULTIRES_VIEW>(
          t.pd() + p * 3, t.dview() + p * t.DVIEW_LD, c - BG_DIN);
    }
  }
}

constexpr int r16(int x) { return (x + 15) & ~15; }

int make_bg(int n_layers, int n_head, int n_a, const int* k, const int* n, const int* kpad,
            const int* npad, const long long* w_off, const long long* wt_off, const int* b_off,
            Bg* bg) {
  if (n_head < 1 || n_layers != BG_HEAD + n_head + 1 || n_layers > BG_MAXL || n_a < 0) return -1;
  bg->n_layers = n_layers;
  bg->n_head = n_head;
  bg->n_a = n_a;
  const int W = n[0], F = n[BG_FEAT];
  bg->W = W;
  bg->F = F;
  for (int i = 0; i < n_layers; ++i) {
    const int want_k = i == 0 ? BG_DPE : i == BG_SKIP + 1 ? BG_DPE + W : i < BG_HEAD ? W
                     : i == BG_HEAD ? F + BG_DVIEW + n_a : n[i - 1];
    const int want_n = i < BG_D ? W : i == BG_ALPHA ? 1 : i == n_layers - 1 ? 3 : n[i];
    // pts5's pack holds its PE in BG_PEPAD columns, then h
    const int want_kpad = i == BG_SKIP + 1 ? BG_PEPAD + W : r16(k[i]);
    const bool hidden = i != BG_ALPHA && i != n_layers - 1;
    if (k[i] != want_k || n[i] != want_n || n[i] <= 0 || (hidden && n[i] % 16) ||
        npad[i] != r16(n[i]) || npad[i] > BG_NR || kpad[i] != want_kpad || kpad[i] > BG_OPW ||
        w_off[i] % 8 || wt_off[i] % 8)
      return -1;
    bg->k[i] = k[i];
    bg->n[i] = n[i];
    bg->kpad[i] = kpad[i];
    bg->npad[i] = npad[i];
    bg->w_off[i] = w_off[i];
    bg->wt_off[i] = wt_off[i];
    bg->b_off[i] = b_off[i];
  }
  // the transposes' row ranges fit a ring slab; the view part, the operand
  if (kpad[BG_HEAD] - F > BG_NR || kpad[BG_ALPHA] != W) return -1;
  return 0;
}

// The GEMM list of K8 (the forward) or K9 (the forward, then the
// transposes), in the order the kernels run their tgemms
bool bg_sched(const Bg& bg, bool bwd, Sched* out) {
  SchedMaker sb;
  sb.maxrows = BG_NR;
  const auto fwd = [&](int i) { sb.add(0, bg.w_off[i], bg.kpad[i], bg.npad[i], bg.kpad[i]); };
  // rows [r0, r0 + rows) of layer i's W^T
  const auto rev = [&](int i, int r0, int rows) {
    sb.add(0, bg.wt_off[i] + (long long)r0 * bg.npad[i], bg.npad[i], rows, bg.npad[i]);
  };
  const int L = bg.n_layers, W = bg.W, F = bg.F;
  for (int l = 0; l < BG_D; ++l) fwd(l);
  fwd(BG_FEAT);
  for (int i = BG_HEAD; i < L - 1; ++i) fwd(i);
  if (bwd) {
    for (int i = L - 1; i > BG_HEAD; --i) rev(i, 0, bg.kpad[i]);
    rev(BG_HEAD, F, bg.kpad[BG_HEAD] - F);
    rev(BG_HEAD, 0, F);
    rev(BG_FEAT, 0, W);
    for (int l = BG_D - 1; l >= 1; --l) rev(l, l == BG_SKIP + 1 ? BG_PEPAD : 0, W);
    rev(0, 0, BG_PEPAD);
    rev(BG_SKIP + 1, 0, BG_PEPAD);
  }
  *out = sb.s;
  return sb.ok;
}

template <typename T>
int launch_fwd(const float* p4, const float* dirs, const float* app, long long n_pts,
               const void* w, const float* b, const Bg& bg, const Sched& sched, float* density,
               float* rgb, cudaStream_t s) {
  using C = FwdCfg<T>;
  auto kern = bg_fwd_kernel<T, C>;
  const size_t smem = bg_bytes<T, C>(0);
  if (int err = prepare(kern, smem, true)) return err;
  kern<<<(unsigned)((n_pts + C::P - 1) / C::P), C::THREADS, smem, s>>>(
      p4, dirs, app, n_pts, static_cast<const T*>(w), b, bg, sched, density, rgb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const float* p4, const float* dirs, const float* app, const float* cot,
               long long n_pts, const void* w, const float* b, const Bg& bg, const Sched& sched,
               const Work& wk, float* d_p4, float* d_dirs, float* d_a, cudaStream_t s) {
  using C = BwdCfg<T>;
  auto kern = bg_bwd_kernel<T, C>;
  const size_t smem = bg_bytes<T, C>(BG_D + bg.n_head);
  if (int err = prepare(kern, smem, true)) return err;
  kern<<<(unsigned)((n_pts + C::P - 1) / C::P), C::THREADS, smem, s>>>(
      p4, dirs, app, cot, n_pts, static_cast<const T*>(w), b, bg, sched, wk, d_p4, d_dirs, d_a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t value (0 = launched) or -1 for shapes
// the kernels do not take. The layers (n_layers = 11 + n_head: pts0..7,
// alpha, feature, the head, rgb) are packed as sdf_vjp.cu's: W (npad, kpad)
// at w_off and W^T (kpad, npad) at wt_off, in float (bf16 == 0) or bf16,
// biases f32 at b_off; pts5's input is [pe | h] with the PE padded to 96
// columns (kpad 96 + W), the head's first [feature | PE_view | a]. app
// holds n_a floats per point (n_a 0: none).

extern "C" int nw_bg_fwd(const float* p4, const float* dirs, const float* app, long long n_pts,
                         const void* w, const float* b, int bf16_act, int n_layers, int n_head,
                         int n_a, const int* k, const int* n, const int* kpad, const int* npad,
                         const long long* w_off, const long long* wt_off, const int* b_off,
                         float* density, float* rgb, void* stream) {
  Bg bg;
  Sched sched;
  if (make_bg(n_layers, n_head, n_a, k, n, kpad, npad, w_off, wt_off, b_off, &bg) ||
      !bg_sched(bg, false, &sched) || (n_a > 0 && !app))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  return bf16_act ? launch_fwd<bf16>(p4, dirs, app, n_pts, w, b, bg, sched, density, rgb, s)
                  : launch_fwd<float>(p4, dirs, app, n_pts, w, b, bg, sched, density, rgb, s);
}

// cot holds per point [c_density, c_rgb (3)]. work is a float32 workspace
// of work_slots * work_rows * 528 elements, work_rows >= n_pts rounded up to
// 64, work_slots >= 21 + 2 n_head; on return it holds layer i's input in
// slot i (i <= 8; feature reads alpha's) or i - 1 (past feature) and its
// cotangent in slot n_layers - 1 + i, for K5.
extern "C" int nw_bg_bwd(const float* p4, const float* dirs, const float* app, const float* cot,
                         long long n_pts, const void* w, const float* b, int bf16_act,
                         int n_layers, int n_head, int n_a, const int* k, const int* n,
                         const int* kpad, const int* npad, const long long* w_off,
                         const long long* wt_off, const int* b_off, float* work,
                         long long work_rows, int work_slots, float* d_p4, float* d_dirs,
                         float* d_a, void* stream) {
  Bg bg;
  Sched sched;
  if (make_bg(n_layers, n_head, n_a, k, n, kpad, npad, w_off, wt_off, b_off, &bg) ||
      !bg_sched(bg, true, &sched) || work_rows < ((n_pts + 63) / 64) * 64 ||
      work_slots < 2 * n_layers - 1 || (n_a > 0 && (!app || !d_a)))
    return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  return bf16_act ? launch_bwd<bf16>(p4, dirs, app, cot, n_pts, w, b, bg, sched, wk, d_p4, d_dirs,
                                     d_a, s)
                  : launch_bwd<float>(p4, dirs, app, cot, n_pts, w, b, bg, sched, wk, d_p4,
                                      d_dirs, d_a, s);
}
