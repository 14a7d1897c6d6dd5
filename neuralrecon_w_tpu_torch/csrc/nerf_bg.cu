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
// What bounds it: ~0.6 M weights, ~1.3 MFLOP a point forward and ~2.6
// backward (dX and dW) against ~80 bytes of inputs and outputs a point, so
// arithmetic bounds it. The TPU kernel kept every dW accumulator in VMEM in
// one call; on the card 2.6 MB of f32 dW does not fit 227 KB of shared
// memory, so K9 leaves per layer its (cotangent, input) rows in the
// workspace and K5 (nw_dw_reduce, sdf_vjp.cu) reduces them.
//
// The design, simple first, as the SDF kernels: one block per tile of
// points (bf16: 64 points, 16 warps, mma.sync; float: 32 points, 8 warps,
// FMA), each layer a tile GEMM over the block's own workspace rows with its
// epilogue fused (sdf_tile.cuh). K8 keeps its hidden states in two rows in
// turns; K9 keeps every layer's input and cotangent. GEMM operands are
// rounded to the activation dtype as they are staged, every sum and bias
// is f32, the hidden state stays f32 between layers, as in the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sdf_tile.cuh"

namespace {

constexpr int BG_D = 8, BG_SKIP = 4, BG_MULTIRES = 10, BG_MULTIRES_VIEW = 4, BG_DIN = 4;
constexpr int BG_DPE = BG_DIN * (1 + 2 * BG_MULTIRES);        // 84
constexpr int BG_DVIEW = 3 * (1 + 2 * BG_MULTIRES_VIEW);      // 27
constexpr int BG_ALPHA = BG_D, BG_FEAT = BG_D + 1, BG_HEAD = BG_D + 2;
constexpr int BG_MAXL = 16;

// layers 0 .. 7 the MLP, 8 alpha, 9 feature, 10 .. 9 + H the head, 10 + H rgb
struct Bg {
  int n_layers, n_head, n_a;
  int k[BG_MAXL], n[BG_MAXL], kpad[BG_MAXL], npad[BG_MAXL], b_off[BG_MAXL];
  long long w_off[BG_MAXL], wt_off[BG_MAXL];
};

// channel c of [v, sin(v), cos(v), sin(2v), cos(2v), ...] for a d-vector
__device__ __forceinline__ float pe_value_n(const float* v, int d, int c) {
  if (c < d) return v[c];
  const int i = (c - d) / (2 * d), r = (c - d) - 2 * d * i;
  const float f = (float)(1 << i);
  return r < d ? sinf(f * v[r]) : cosf(f * v[r - d]);
}

// Jpe(v)^T g for a d-vector (pallas_nerf_bg.py:_pe_transpose)
__device__ __forceinline__ void pe_transpose(const float* v, int d, int multires, const float* g,
                                             float* out) {
  for (int a = 0; a < d; ++a) {
    float s = g[a], f = 1.0f;
    for (int i = 0; i < multires; ++i, f *= 2.0f)
      s += g[d * (1 + 2 * i) + a] * f * cosf(f * v[a]) - g[d * (2 + 2 * i) + a] * f * sinf(f * v[a]);
    out[a] = s;
  }
}

struct ReluEpi {  // out = relu(acc + b), or acc + b
  const float* b; float* out; bool relu;
  __device__ void operator()(int p, int j, float acc) const {
    const float z = acc + b[j];
    out[(long long)p * WMAX + j] = relu ? fmaxf(z, 0.0f) : z;
  }
};

struct OutColsEpi {  // acc + b into an (N, ld) output, for the tile's points
  const float* b; float* out; int ld; long long n_valid;
  __device__ void operator()(int p, int j, float acc) const {
    if (p < n_valid) out[(long long)p * ld + j] = acc + b[j];
  }
};

struct NoAlpha {};

// The forward over the tile into the rows in[] (in[9] == in[8]): the MLP,
// then (K8) the alpha head through `alpha`, the feature head into the
// first columns of in[10], the appearance head; in[10 + H] ends holding
// the rgb layer's input.
template <typename T, class Alpha>
__device__ void bg_forward(const float* p4, const float* dirs, const float* app, long long n_valid,
                           const T* w, const float* b, const Bg& bg, float* const* in, float* sm,
                           Alpha* alpha, int P) {
  const int W = bg.n[0], F = bg.n[BG_FEAT];
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool ok = p < n_valid;
    const long long o = (long long)p * WMAX;
    float x[BG_DIN], d[3];
    for (int a = 0; a < BG_DIN; ++a) x[a] = ok ? p4[(long long)p * BG_DIN + a] : 0.0f;
    for (int a = 0; a < 3; ++a) d[a] = ok ? dirs[(long long)p * 3 + a] : 0.0f;
    for (int c = 0; c < BG_DPE; ++c) {
      const float v = pe_value_n(x, BG_DIN, c);
      in[0][o + c] = v;
      in[BG_SKIP + 1][o + c] = v;
    }
    for (int c = 0; c < BG_DVIEW; ++c) in[BG_HEAD][o + F + c] = pe_value_n(d, 3, c);
    for (int c = 0; c < bg.n_a; ++c)
      in[BG_HEAD][o + F + BG_DVIEW + c] = ok ? app[(long long)p * bg.n_a + c] : 0.0f;
  }
  __syncthreads();
  for (int i = 0; i < BG_D; ++i) {
    ReluEpi e{b + bg.b_off[i], i == BG_SKIP ? in[i + 1] + BG_DPE : in[i + 1], true};
    gemm(in[i], bg.k[i], w + bg.w_off[i], bg.kpad[i], W, sm, e);
  }
  if constexpr (!std::is_same<Alpha, NoAlpha>::value)
    gemm(in[BG_ALPHA], bg.k[BG_ALPHA], w + bg.w_off[BG_ALPHA], bg.kpad[BG_ALPHA], 1, sm, *alpha);
  {
    ReluEpi e{b + bg.b_off[BG_FEAT], in[BG_HEAD], false};
    gemm(in[BG_FEAT], bg.k[BG_FEAT], w + bg.w_off[BG_FEAT], bg.kpad[BG_FEAT], F, sm, e);
  }
  for (int i = BG_HEAD; i < BG_HEAD + bg.n_head; ++i) {
    ReluEpi e{b + bg.b_off[i], in[i + 1], true};
    gemm(in[i], bg.k[i], w + bg.w_off[i], bg.kpad[i], bg.n[i], sm, e);
  }
}

// K8
template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
bg_fwd_kernel(const float* __restrict__ p4, const float* __restrict__ dirs,
              const float* __restrict__ app, long long n_pts, const T* __restrict__ w,
              const float* __restrict__ b, Bg bg, Work wk, float* __restrict__ density,
              float* __restrict__ rgb) {
  extern __shared__ __align__(16) float smem[];
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  // rows: 0 PE, 1 / 2 the hidden state in turns, 3 [pe | h5], 4 the head's input
  float* in[BG_MAXL];
  for (int i = 0; i < bg.n_layers; ++i) {
    const int h = i - BG_HEAD;
    in[i] = i == 0 ? wk.slot(0, p0) : i == BG_SKIP + 1 ? wk.slot(3, p0)
          : i == BG_HEAD ? wk.slot(4, p0)
          : wk.slot(((i < BG_HEAD ? i : h) & 1) ? 1 : 2, p0);
  }
  in[BG_FEAT] = in[BG_ALPHA];
  OutColsEpi alpha{b + bg.b_off[BG_ALPHA], density + p0, 1, n_valid};
  bg_forward<T>(p4 + p0 * BG_DIN, dirs + p0 * 3, app ? app + p0 * bg.n_a : nullptr, n_valid, w, b,
                bg, in, smem, &alpha, P);
  const int l = bg.n_layers - 1;
  OutColsEpi e{b + bg.b_off[l], rgb + p0 * 3, 3, n_valid};
  gemm(in[l], bg.k[l], w + bg.w_off[l], bg.kpad[l], bg.n[l], smem, e);
}

struct MaskEpi {  // through a ReLU: r where the layer's output H is positive
  float* G; const float* H;
  __device__ void operator()(int p, int j, float r) const {
    const long long o = (long long)p * WMAX + j;
    G[o] = r * (H[o] > 0.0f ? 1.0f : 0.0f);
  }
};

struct HeadInBackEpi {  // r on [feature | PE_view | a]
  float* Gf; float* dpev; float* da; int f, n_a; long long n_valid;
  __device__ void operator()(int p, int j, float r) const {
    const long long o = (long long)p * WMAX;
    if (j < f) Gf[o + j] = r;
    else if (j < f + BG_DVIEW) dpev[o + j - f] = r;
    else if (p < n_valid) da[(long long)p * n_a + j - f - BG_DVIEW] = r;
  }
};

struct StoreEpi {
  float* out;
  __device__ void operator()(int p, int j, float r) const { out[(long long)p * WMAX + j] = r; }
};

struct AddMaskEpi {  // (partial + r) through the ReLU of H
  float* G; const float* H;
  __device__ void operator()(int p, int j, float r) const {
    const long long o = (long long)p * WMAX + j;
    G[o] = (G[o] + r) * (H[o] > 0.0f ? 1.0f : 0.0f);
  }
};

struct SkipBackEpi {  // r on [pe | h5]: the PE's cotangent (first term), h5's
  float* dpe; float* G; const float* H;
  __device__ void operator()(int p, int j, float r) const {
    const long long o = (long long)p * WMAX;
    if (j < BG_DPE) dpe[o + j] = r;
    else G[o + j - BG_DPE] = r * (H[o + j] > 0.0f ? 1.0f : 0.0f);
  }
};

struct PeAddEpi {
  float* dpe;
  __device__ void operator()(int p, int j, float r) const { dpe[(long long)p * WMAX + j] += r; }
};

__host__ __device__ inline int bg_bwd_slots(int n_head) { return 23 + 2 * n_head; }

// K9
template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
bg_bwd_kernel(const float* __restrict__ p4, const float* __restrict__ dirs,
              const float* __restrict__ app, const float* __restrict__ cot, long long n_pts,
              const T* __restrict__ w, const float* __restrict__ b, Bg bg, Work wk,
              float* __restrict__ d_p4, float* __restrict__ d_dirs, float* __restrict__ d_a) {
  extern __shared__ __align__(16) float smem[];
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  const int NL = bg.n_layers, F = bg.n[BG_FEAT];
  // slots: layer i's input (in[9] is in[8]), then layer i's cotangent, d_pe, d_pe_view
  float* in[BG_MAXL];
  float* G[BG_MAXL];
  for (int i = 0; i < NL; ++i) {
    in[i] = wk.slot(i <= BG_ALPHA ? i : i - 1, p0);
    G[i] = wk.slot(NL - 1 + i, p0);
  }
  in[BG_FEAT] = in[BG_ALPHA];
  float* dpe = wk.slot(2 * NL - 1, p0);
  float* dpev = wk.slot(2 * NL, p0);
  bg_forward<T, NoAlpha>(p4 + p0 * BG_DIN, dirs + p0 * 3, app ? app + p0 * bg.n_a : nullptr,
                         n_valid, w, b, bg, in, smem, nullptr, P);

  // the cotangents on the two linear outputs: [c_density | c_rgb]
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool ok = p < n_valid;
    const long long o = (long long)p * WMAX;
    G[BG_ALPHA][o] = ok ? cot[(p0 + p) * 4] : 0.0f;
    for (int j = 0; j < 3; ++j) G[NL - 1][o + j] = ok ? cot[(p0 + p) * 4 + 1 + j] : 0.0f;
  }
  __syncthreads();
  // the head, r = g W per layer through the ReLU masks
  for (int i = NL - 1; i > BG_HEAD; --i) {
    MaskEpi e{G[i - 1], in[i]};
    gemm(G[i], bg.n[i], w + bg.wt_off[i], bg.npad[i], bg.k[i], smem, e);
  }
  {
    HeadInBackEpi e{G[BG_FEAT], dpev, d_a ? d_a + p0 * bg.n_a : nullptr, F, bg.n_a, n_valid};
    gemm(G[BG_HEAD], bg.n[BG_HEAD], w + bg.wt_off[BG_HEAD], bg.npad[BG_HEAD], bg.k[BG_HEAD],
         smem, e);
  }
  // feature + alpha join on the last hidden state
  {
    StoreEpi e1{G[BG_D - 1]};
    gemm(G[BG_FEAT], F, w + bg.wt_off[BG_FEAT], bg.npad[BG_FEAT], bg.k[BG_FEAT], smem, e1);
    AddMaskEpi e2{G[BG_D - 1], in[BG_D]};
    gemm(G[BG_ALPHA], 1, w + bg.wt_off[BG_ALPHA], bg.npad[BG_ALPHA], bg.k[BG_ALPHA], smem, e2);
  }
  // the MLP top-down; the PE's cotangent from the skip and layer 0
  for (int i = BG_D - 1; i >= 0; --i) {
    const T* wt = w + bg.wt_off[i];
    if (i == 0) {
      PeAddEpi e{dpe};
      gemm(G[0], bg.n[0], wt, bg.npad[0], bg.k[0], smem, e);
    } else if (i == BG_SKIP + 1) {
      SkipBackEpi e{dpe, G[i - 1], in[i]};
      gemm(G[i], bg.n[i], wt, bg.npad[i], bg.k[i], smem, e);
    } else {
      MaskEpi e{G[i - 1], in[i]};
      gemm(G[i], bg.n[i], wt, bg.npad[i], bg.k[i], smem, e);
    }
  }
  for (int p = threadIdx.x; p < P && p < n_valid; p += blockDim.x) {
    const long long o = (long long)p * WMAX;
    float x[BG_DIN], d[3], g[BG_DIN];
    for (int a = 0; a < BG_DIN; ++a) x[a] = p4[(p0 + p) * BG_DIN + a];
    for (int a = 0; a < 3; ++a) d[a] = dirs[(p0 + p) * 3 + a];
    pe_transpose(x, BG_DIN, BG_MULTIRES, dpe + o, g);
    for (int a = 0; a < BG_DIN; ++a) d_p4[(p0 + p) * BG_DIN + a] = g[a];
    pe_transpose(d, 3, BG_MULTIRES_VIEW, dpev + o, g);
    for (int a = 0; a < 3; ++a) d_dirs[(p0 + p) * 3 + a] = g[a];
  }
}

int make_bg(int n_layers, int n_head, int n_a, const int* k, const int* n, const int* kpad,
            const int* npad, const long long* w_off, const long long* wt_off, const int* b_off,
            Bg* bg) {
  if (n_head < 1 || n_layers != BG_HEAD + n_head + 1 || n_layers > BG_MAXL || n_a < 0) return -1;
  bg->n_layers = n_layers;
  bg->n_head = n_head;
  bg->n_a = n_a;
  const int W = n[0], F = n[BG_FEAT];
  for (int i = 0; i < n_layers; ++i) {
    const int want_k = i == 0 ? BG_DPE : i == BG_SKIP + 1 ? BG_DPE + W : i < BG_HEAD ? W
                     : i == BG_HEAD ? F + BG_DVIEW + n_a : n[i - 1];
    const int want_n = i < BG_D ? W : i == BG_ALPHA ? 1 : i == n_layers - 1 ? 3 : n[i];
    if (k[i] != want_k || n[i] != want_n || n[i] <= 0 || n[i] > NMAX || k[i] > WMAX ||
        kpad[i] != ((k[i] + 15) & ~15) || npad[i] != ((n[i] + 15) & ~15) || w_off[i] % 8 ||
        wt_off[i] % 8)
      return -1;
    bg->k[i] = k[i];
    bg->n[i] = n[i];
    bg->kpad[i] = kpad[i];
    bg->npad[i] = npad[i];
    bg->w_off[i] = w_off[i];
    bg->wt_off[i] = wt_off[i];
    bg->b_off[i] = b_off[i];
  }
  return 0;
}

}  // namespace

// Each entry returns a cudaError_t value (0 = launched) or -1 for shapes
// the kernels do not take. The layers (n_layers = 11 + n_head: pts0..7,
// alpha, feature, the head, rgb) are packed as sdf_vjp.cu's: W (npad,
// kpad) at w_off and W^T (kpad, npad) at wt_off, in float (bf16 == 0) or
// bf16, biases f32 at b_off; pts5's input is [pe | h], the head's first
// [feature | PE_view | a]. app holds n_a floats per point (n_a 0: none).
// work is a float32 workspace of work_slots * work_rows * 528 elements,
// work_rows >= n_pts rounded up to 64, work_slots >= 5 for K8 and
// 23 + 2 n_head for K9.

extern "C" int nw_bg_fwd(const float* p4, const float* dirs, const float* app, long long n_pts,
                         const void* w, const float* b, int bf16_act, int n_layers, int n_head,
                         int n_a, const int* k, const int* n, const int* kpad, const int* npad,
                         const long long* w_off, const long long* wt_off, const int* b_off,
                         float* work, long long work_rows, int work_slots, float* density,
                         float* rgb, void* stream) {
  Bg bg;
  if (make_bg(n_layers, n_head, n_a, k, n, kpad, npad, w_off, wt_off, b_off, &bg) ||
      work_rows < ((n_pts + 63) / 64) * 64 || work_slots < 5 || (n_a > 0 && !app))
    return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = bg_fwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = (size_t)(M_P + NMAX) * M_ST * sizeof(bf16);
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        p4, dirs, app, n_pts, static_cast<const bf16*>(w), b, bg, wk, density, rgb);
  } else {
    auto kern = bg_fwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = (size_t)(F_P * F_KC + F_KC * NMAX) * sizeof(float);
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        p4, dirs, app, n_pts, static_cast<const float*>(w), b, bg, wk, density, rgb);
  }
  return (int)cudaGetLastError();
}

// cot holds per point [c_density, c_rgb (3)].
extern "C" int nw_bg_bwd(const float* p4, const float* dirs, const float* app, const float* cot,
                         long long n_pts, const void* w, const float* b, int bf16_act,
                         int n_layers, int n_head, int n_a, const int* k, const int* n,
                         const int* kpad, const int* npad, const long long* w_off,
                         const long long* wt_off, const int* b_off, float* work,
                         long long work_rows, int work_slots, float* d_p4, float* d_dirs,
                         float* d_a, void* stream) {
  Bg bg;
  if (make_bg(n_layers, n_head, n_a, k, n, kpad, npad, w_off, wt_off, b_off, &bg) ||
      work_rows < ((n_pts + 63) / 64) * 64 || work_slots < bg_bwd_slots(n_head) ||
      (n_a > 0 && (!app || !d_a)))
    return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = bg_bwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = (size_t)(M_P + NMAX) * M_ST * sizeof(bf16);
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        p4, dirs, app, cot, n_pts, static_cast<const bf16*>(w), b, bg, wk, d_p4, d_dirs, d_a);
  } else {
    auto kern = bg_bwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = (size_t)(F_P * F_KC + F_KC * NMAX) * sizeof(float);
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        p4, dirs, app, cot, n_pts, static_cast<const float*>(w), b, bg, wk, d_p4, d_dirs, d_a);
  }
  return (int)cudaGetLastError();
}
