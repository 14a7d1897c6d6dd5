// K1: fused SDF MLP forward, (N, 3) points -> (N,) signed distance.
//
// Replaces the TPU kernels ops/pallas_mlp.py:fused_sdf_head (body
// _kernel_entry) and the MLP body _mlp_sdf of ops/pallas_sampler.py,
// which the importance sampler runs on every sample it scores.
//
// What it computes, per point: x * scale; the positional encoding
// [x, sin 2^i x, cos 2^i x] (i < multires); the hidden layers with
// softplus(beta 100, threshold 20), the skip layers fed [h, pe] / sqrt 2;
// and column 0 of the last layer, divided by scale. Activations are
// stored in float, or in bf16 with every product summed in f32 and the
// bias added in f32 (the Pallas sampler's preferred_element_type dots).
//
// What bounds it: about 3.7 MFLOP per point at the 8 x 512 width against
// 12 bytes in and 4 out, so arithmetic bounds it, not device memory: in
// bf16 the tensor cores' 989 TFLOP/s, in f32 the fastest f32-accurate
// route, three TF32 products per f32 one at 495 / 3 = 165 TFLOP/s (the FMA
// pipes give 67). The weights (8.5 MB in f32, 4.3 MB in bf16) are re-read
// by every block from the 50 MB L2, so points per block set the L2 traffic.
//
// The design: one block per tile of points. The hidden activations stay in
// one shared-memory buffer and never leave the SM: each layer's output is
// written over its input after its products, behind a barrier. The last
// layer's 512-wide feature is never formed (only column 0 is computed, one
// warp per point). Weights are packed (N_pad, K_pad) with k contiguous, as
// torch's (d_out, d_in) layout is, and stream through a cp.async ring of
// k-slabs that runs ahead across layer boundaries; one barrier per slab.
// The softplus epilogue uses the fast exp / log (softplus100_fast): with
// the accurate ones it took as long as the products.
//  * bf16: 64 points, 16 warps, mma.sync m16n8k16 (bf16 in, f32
//    accumulate); a three-stage ring of 32-wide slabs (see the bf16
//    section).
//  * float: 64 points, 16 warps, split-TF32 mma.sync m16n8k8 (see the float
//    section); a two-stage ring of 16-wide slabs.
// wgmma is not used: a 64-row warpgroup tile holds 128 f32 accumulators a
// thread per 256 columns, so the in-place output of a 512-wide layer caps a
// block at 64 points, as here, and 64-point blocks re-read the weights
// from L2 (4.4 GB at 65,536 points), which would bound a wgmma kernel near
// the time of this one; 128-point blocks need the weight slabs multicast to
// a cluster of SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

using namespace nw;

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int NMAX = 512;   // widest layer (inputs and outputs)
constexpr int PE_MAX = 64;  // widest positional encoding (3 * (1 + 2 * 10))
constexpr float INV_SQRT2 = 0.70710678118654752440f;

struct Dims {
  int n_layers;   // linear layers, the last one included
  int multires;
  int d_pe;
  int skip_mask;  // bit l: layer l is fed [h, pe] / sqrt 2
  float scale;
  int k[MAX_LAYERS];      // input width of layer l
  int kpad[MAX_LAYERS];   // row stride of layer l's (npad, kpad) weight
  int n[MAX_LAYERS];      // output width of layer l
  int npad[MAX_LAYERS];   // rows of layer l's weight (and biases)
  long long woff[MAX_LAYERS];  // element offset of layer l's weight
  int boff[MAX_LAYERS];   // offset of layer l's f32 bias
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// x * scale and its positional encoding for the block's points, as T,
// zero past d_pe up to the row stride; padding points are 0
template <typename T>
__device__ void positional_encoding(const float* pts, long long n_pts, long long p0, int tp,
                                    const Dims& dims, T* pe, int pst) {
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    float x[3] = {0.0f, 0.0f, 0.0f};
    if (p0 + p < n_pts)
      for (int a = 0; a < 3; ++a) x[a] = pts[(p0 + p) * 3 + a] * dims.scale;
    T* row = pe + p * pst;
    for (int a = 0; a < 3; ++a) row[a] = from_f<T>(x[a]);
    float f = 1.0f;
    for (int i = 0; i < dims.multires; ++i, f *= 2.0f)
      for (int a = 0; a < 3; ++a) {
        row[3 + 6 * i + a] = from_f<T>(sinf(f * x[a]));
        row[6 + 6 * i + a] = from_f<T>(cosf(f * x[a]));
      }
    for (int c = dims.d_pe; c < pst; ++c) row[c] = from_f<T>(0.0f);
  }
}

// [h, pe] / sqrt 2 for skip layer l, rounded to T, in place over h
template <typename T>
__device__ void skip_concat(T* h, int ast, const T* pe, int pst, int tp, int K, int d_pe) {
  const int wh = K - d_pe;
  for (int e = threadIdx.x; e < tp * K; e += blockDim.x) {
    const int p = e / K, col = e - p * K;
    const float v = col < wh ? to_f(h[p * ast + col]) : to_f(pe[p * pst + col - wh]);
    h[p * ast + col] = from_f<T>(v * INV_SQRT2);
  }
}

// last layer, column 0 only: one warp per point, lanes split k
template <typename T>
__device__ void last_column(const T* in, int ast, int tp, int K, const T* w, float b,
                            float scale, long long p0, long long n_pts, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < tp; p += blockDim.x / 32) {
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) s += to_f(in[p * ast + k]) * to_f(w[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && p0 + p < n_pts) out[p0 + p] = (s + b) / scale;
  }
}

// The weight stream: the k-slabs of KS columns of layers 0 .. L-2 in order,
// every weight row of a layer in each. The cursor names the next slab to
// load; it runs ahead of the layer being multiplied, across layer
// boundaries, so the ring never drains.
template <int KS>
struct Cursor {
  int l = 0, k0 = 0;
  __device__ bool valid(const Dims& d) const { return l < d.n_layers - 1; }
  __device__ void advance(const Dims& d) {
    k0 += KS;
    if (k0 >= d.kpad[l]) k0 = 0, ++l;
  }
};

// rows [0, npad) of k-columns [k0, k0 + KS) of layer l's (npad, kpad) weight
// -> slab (row stride WST), 16-byte cp.async copies, consecutive threads on
// consecutive 16 bytes of a row
template <typename T, int KS, int WST, int THREADS>
__device__ __forceinline__ void load_slab(T* slab, const T* W, const Dims& d, const Cursor<KS>& c) {
  constexpr int V = 16 / sizeof(T);  // elements per copy
  const T* w = W + d.woff[c.l] + c.k0;
  const int chunks = min(KS, d.kpad[c.l] - c.k0) / V;  // per row
  for (int e = threadIdx.x; e < d.npad[c.l] * chunks; e += THREADS) {
    const int r = e / chunks, j = e - r * chunks;
    cp_async16(slab + r * WST + V * j, w + (long long)r * d.kpad[c.l] + V * j);
  }
}

// 64 points a block, 16 warps, each a 32 x 64 output tile. The activations
// stay in one 64-row buffer, each layer's output written over its input
// behind a barrier (the accumulators hold it until then). Row strides are
// padded by 16 bytes so the fragment reads hit distinct banks.
//  * float: split-TF32 mma.sync m16n8k8. Every f32 operand is split as hi +
//    lo in TF32 and c += a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in f32,
//    which keeps f32 accuracy (~2^-22 per product) at up to 495 / 3 = 165
//    TFLOP/s. 16-wide k-slabs in a two-stage ring: the 64 x 516 f32
//    activations leave no room for a third.
//  * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix;
//    32-wide k-slabs in a three-stage ring. (A 128-point tile halves the
//    weights' L2 traffic, but its 128 x 512 f32 accumulators do not fit in
//    registers: a layer then runs in two passes of 256 columns, the first
//    pass's output waiting in registers, which leaves two warps per
//    scheduler, and it ran slower on the H100.)

constexpr int K1_TP = 64, K1_THREADS = 512;

template <typename T> struct K1Cfg;
template <> struct K1Cfg<float> {
  static constexpr int KS = 16, STAGES = 2, AST = NMAX + 4, PST = PE_MAX + 4, WST = KS + 4;
};
template <> struct K1Cfg<bf16> {
  static constexpr int KS = 32, STAGES = 3, AST = NMAX + 8, PST = PE_MAX + 8, WST = KS + 8;
};

template <typename T>
constexpr size_t k1_smem() {
  using C = K1Cfg<T>;
  return (K1_TP * C::AST + K1_TP * C::PST + C::STAGES * NMAX * C::WST) * sizeof(T);
}

// the products of kw k-columns of a slab of npad weight rows: warp (row0,
// col0)'s 32 x 64 tile
__device__ __forceinline__ void slab_products(const float* in, int ist, int k0, const float* slab,
                                              int kw, int npad, float (&acc)[2][8][4]) {
  constexpr int WST = K1Cfg<float>::WST;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 64;
  const int g = lane >> 2, c = lane & 3;
  if (col0 >= npad) return;
#pragma unroll
  for (int kk = 0; kk < K1Cfg<float>::KS; kk += 8) {
    if (kk >= kw) break;
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = in + (row0 + 16 * mi + g) * ist + k0 + kk + c;
      tf32_split(a[0], ah[mi][0], al[mi][0]);
      tf32_split(a[8 * ist], ah[mi][1], al[mi][1]);
      tf32_split(a[4], ah[mi][2], al[mi][2]);
      tf32_split(a[8 * ist + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = col0 + 8 * ni;
      if (n >= npad) break;
      const float* b = slab + (n + g) * WST + kk + c;
      unsigned bh0, bl0, bh1, bl1;
      tf32_split(b[0], bh0, bl0);
      tf32_split(b[4], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
    }
  }
}

__device__ __forceinline__ void slab_products(const bf16* in, int ist, int k0, const bf16* slab,
                                              int kw, int npad, float (&acc)[2][8][4]) {
  constexpr int WST = K1Cfg<bf16>::WST;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 64;
  if (col0 >= npad) return;
#pragma unroll
  for (int kk = 0; kk < K1Cfg<bf16>::KS; kk += 16) {
    if (kk >= kw) break;
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], in + (row0 + 16 * mi + (lane & 15)) * ist + k0 + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = col0 + 16 * nj;
      if (n >= npad) break;
      unsigned b[4];
      ldmatrix_x4(b, slab + (n + (lane & 7) + ((lane >> 4) << 3)) * WST + kk +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        if (n + 8 < npad) mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(K1_THREADS, 1)
sdf_mlp_kernel(const float* __restrict__ pts, long long n_pts, const T* __restrict__ W,
               const float* __restrict__ B, Dims dims, float* __restrict__ out) {
  using C = K1Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);  // K1_TP x AST
  T* pe = act + K1_TP * C::AST;         // K1_TP x PST
  T* ring = pe + K1_TP * C::PST;        // STAGES x NMAX x WST
  const long long p0 = (long long)blockIdx.x * K1_TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 64;
  const int L = dims.n_layers;

  Cursor<C::KS> ld;
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (ld.valid(dims)) {
      load_slab<T, C::KS, C::WST, K1_THREADS>(ring + st * NMAX * C::WST, W, dims, ld);
      ld.advance(dims);
    }
    cp_async_commit();
  }
  positional_encoding<T>(pts, n_pts, p0, K1_TP, dims, pe, C::PST);
  __syncthreads();
  const T* in = pe;
  int ist = C::PST, t = 0;
  for (int l = 0; l < L - 1; ++l) {
    if ((dims.skip_mask >> l) & 1) {
      skip_concat<T>(act, C::AST, pe, C::PST, K1_TP, dims.k[l], dims.d_pe);
      in = act;
      ist = C::AST;
    }
    float acc[2][8][4] = {};
    for (int k0 = 0; k0 < dims.kpad[l]; k0 += C::KS, ++t) {
      cp_async_wait<C::STAGES - 2>();  // slab t has landed
      __syncthreads();  // for every thread, and slab t - 1 is consumed
      if (ld.valid(dims)) {
        load_slab<T, C::KS, C::WST, K1_THREADS>(
            ring + ((t + C::STAGES - 1) % C::STAGES) * NMAX * C::WST, W, dims, ld);
        ld.advance(dims);
      }
      cp_async_commit();
      slab_products(in, ist, k0, ring + (t % C::STAGES) * NMAX * C::WST,
                    min(C::KS, dims.kpad[l] - k0), dims.npad[l], acc);
    }
    __syncthreads();  // every warp has read the layer's input
    const float* bias = B + dims.boff[l];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = col0 + 8 * ni + 2 * (lane & 3);
        if (n >= dims.npad[l]) continue;
        const int r = row0 + 16 * mi + (lane >> 2);
        const float b0 = bias[n], b1 = bias[n + 1];
        store_pair(act + r * C::AST + n, softplus100_fast(acc[mi][ni][0] + b0),
                   softplus100_fast(acc[mi][ni][1] + b1));
        store_pair(act + (r + 8) * C::AST + n, softplus100_fast(acc[mi][ni][2] + b0),
                   softplus100_fast(acc[mi][ni][3] + b1));
      }
    __syncthreads();
    in = act;
    ist = C::AST;
  }
  last_column<T>(in, ist, K1_TP, dims.k[L - 1], W + dims.woff[L - 1], B[dims.boff[L - 1]],
                 dims.scale, p0, n_pts, out);
}

template <typename T>
int launch(const float* pts, long long n_pts, const T* w, const float* b, const Dims& dims,
           float* out, cudaStream_t stream) {
  const auto kernel = sdf_mlp_kernel<T>;
  const size_t smem = k1_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pts + K1_TP - 1) / K1_TP;
  if (blocks > 0) kernel<<<(unsigned)blocks, K1_THREADS, smem, stream>>>(pts, n_pts, w, b, dims, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 = launched), or -1 for dimensions the
// kernel does not take. Host arrays k, kpad, n, npad, woff, boff have
// n_layers entries; w is float (bf16 == 0) or bf16 (bf16 == 1), packed
// (npad, kpad) per layer with the last layer's column 0 as one row; b is
// float, npad entries per layer.
extern "C" int nw_sdf_mlp(const float* pts, long long n_pts, const void* w, const float* b,
                          int bf16_act, int n_layers, int multires, float scale, int skip_mask,
                          const int* k, const int* kpad, const int* n, const int* npad,
                          const long long* woff, const int* boff, float* out, void* stream) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || multires < 0 ||
      3 * (1 + 2 * multires) > PE_MAX || (skip_mask & 1))
    return -1;
  Dims dims;
  dims.n_layers = n_layers;
  dims.multires = multires;
  dims.d_pe = 3 * (1 + 2 * multires);
  dims.skip_mask = skip_mask;
  dims.scale = scale;
  for (int l = 0; l < n_layers; ++l) {
    const bool hidden = l < n_layers - 1;
    if (k[l] > NMAX || kpad[l] < k[l] || (hidden && (n[l] > NMAX || npad[l] > NMAX)))
      return -1;
    // the tensor-core products read every input column below kpad: it
    // must lie in what the previous layer wrote (or the skip concat / the PE)
    const bool skip = (skip_mask >> l) & 1;
    if (kpad[l] % 16 || kpad[l] > (l == 0 ? PE_MAX : NMAX) ||
        (hidden && (npad[l] % 8 || npad[l] < n[l])) || (skip && kpad[l] != k[l]) ||
        (l > 0 && hidden && !skip && kpad[l] > npad[l - 1]))
      return -1;
    dims.k[l] = k[l];
    dims.kpad[l] = kpad[l];
    dims.n[l] = n[l];
    dims.npad[l] = npad[l];
    dims.woff[l] = woff[l];
    dims.boff[l] = boff[l];
  }
  if (dims.k[0] != dims.d_pe) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_act) return launch(pts, n_pts, static_cast<const bf16*>(w), b, dims, out, s);
  return launch(pts, n_pts, static_cast<const float*>(w), b, dims, out, s);
}
