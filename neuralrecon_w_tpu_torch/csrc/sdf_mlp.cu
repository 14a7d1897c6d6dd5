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
// 12 bytes in and 4 out, so arithmetic bounds it, not device memory. The
// weights (8.5 MB in f32, 4.3 MB in bf16) are re-read by every block
// from the 50 MB L2.
//
// The design: one block per tile of points. The hidden activations
// ping-pong between two shared-memory buffers and never leave the SM; the
// last layer's 512-wide feature is never formed (only column 0 is
// computed, one warp per point). Weights are packed (N_pad, K_pad) with k
// contiguous, as torch's (d_out, d_in) layout is.
//  * bf16: 64 points, 16 warps. Products run on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate); each warp owns a
//    32 x 64 output tile. Weight slabs of 32 k-columns stream into shared
//    memory with cp.async, double-buffered, while the previous slab is
//    multiplied. ldmatrix feeds both operands; row strides are padded by
//    16 bytes so its eight row reads hit distinct banks.
//  * float: 32 points, 8 warps, FMA pipes (the tensor cores have no exact
//    f32 product). Each thread owns 8 points x 8 columns, so one float4
//    weight read feeds 32 FMAs; weight slabs of 16 k-rows are staged in
//    shared memory.
// wgmma and TMA-fed slabs are the next step for the bf16 path.
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

// ------------------------------ float: FMA ------------------------------

constexpr int F_TP = 32;       // points per block
constexpr int F_THREADS = 256;
constexpr int F_PT = 8;        // points per thread
constexpr int F_KC = 16;       // weight k-rows per staged slab

// out[p][col] = softplus(sum_k in[p][k] W[col][k] + b[col])
__device__ void dense_f32(const float* in, int in_stride, int K, const float* W, int kpad,
                          int N, const float* bias, float* out, float* wt) {
  const int tid = threadIdx.x;
  const int c = tid & 63;   // column group: [4c, 4c+4) and [256+4c, 256+4c+4)
  const int g = tid >> 6;   // point group: points [g*F_PT, g*F_PT+F_PT)
  float acc[F_PT][8];
#pragma unroll
  for (int i = 0; i < F_PT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += F_KC) {
    __syncthreads();  // the previous slab is consumed
    for (int col = tid; col < N; col += F_THREADS) {
      const float* src = W + (long long)col * kpad + k0;
      for (int r = 0; r < F_KC; ++r) wt[r * NMAX + col] = k0 + r < K ? src[r] : 0.0f;
    }
    __syncthreads();
    const int kend = min(F_KC, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(&wt[kk * NMAX + 4 * c]);
      const float4 w1 = *reinterpret_cast<const float4*>(&wt[kk * NMAX + 256 + 4 * c]);
#pragma unroll
      for (int i = 0; i < F_PT; ++i) {
        const float a = in[(g * F_PT + i) * in_stride + k0 + kk];
        acc[i][0] += a * w0.x; acc[i][1] += a * w0.y;
        acc[i][2] += a * w0.z; acc[i][3] += a * w0.w;
        acc[i][4] += a * w1.x; acc[i][5] += a * w1.y;
        acc[i][6] += a * w1.z; acc[i][7] += a * w1.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F_PT; ++i) {
    const int p = g * F_PT + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * c : 256 + 4 * c) + (j & 3);
      if (col < N) out[p * NMAX + col] = softplus100(acc[i][j] + bias[col]);
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
sdf_mlp_f32_kernel(const float* __restrict__ pts, long long n_pts, const float* __restrict__ W,
                   const float* __restrict__ B, Dims dims, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufs[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + F_TP * NMAX};
  float* pe = bufs[1] + F_TP * NMAX;
  float* wt = pe + F_TP * PE_MAX;
  const long long p0 = (long long)blockIdx.x * F_TP;

  positional_encoding<float>(pts, n_pts, p0, F_TP, dims, pe, PE_MAX);
  __syncthreads();
  const float* in = pe;
  int in_stride = PE_MAX, cur = 0;
  const int L = dims.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    if ((dims.skip_mask >> l) & 1) {
      skip_concat<float>(bufs[cur ^ 1], NMAX, pe, PE_MAX, F_TP, dims.k[l], dims.d_pe);
      __syncthreads();
    }
    dense_f32(in, in_stride, dims.k[l], W + dims.woff[l], dims.kpad[l], dims.n[l],
              B + dims.boff[l], bufs[cur], wt);
    __syncthreads();
    in = bufs[cur];
    in_stride = NMAX;
    cur ^= 1;
  }
  last_column<float>(in, NMAX, F_TP, dims.k[L - 1], W + dims.woff[L - 1],
                     B[dims.boff[L - 1]], dims.scale, p0, n_pts, out);
}

// --------------------------- bf16: tensor cores ---------------------------

constexpr int M_TP = 64;           // points per block
constexpr int M_THREADS = 512;     // 16 warps: 2 row blocks x 8 column blocks
constexpr int M_AST = NMAX + 8;    // activation row stride (bf16)
constexpr int M_PST = PE_MAX + 8;  // positional-encoding row stride
constexpr int M_KS = 32;           // k-columns per weight slab
constexpr int M_WST = M_KS + 8;    // weight slab row stride

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [0, npad) of k-columns [k0, k0 + M_KS) of W (npad, kpad) -> slab
__device__ __forceinline__ void load_slab(bf16* slab, const bf16* W, int npad, int kpad, int k0) {
  const int chunks = min(M_KS, kpad - k0) / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < npad * chunks; c += M_THREADS) {
    const int n = c / chunks, j = c - n * chunks;
    cp_async16(slab + n * M_WST + 8 * j, W + (long long)n * kpad + k0 + 8 * j);
  }
}

// out[p][col] = softplus(sum_k in[p][k] W[col][k] + b[col]) for the
// block's 64 points; kpad and npad are multiples of 16 and 8
__device__ void dense_mma(const bf16* in, int ist, int kpad, const bf16* W, int npad,
                          const float* bias, bf16* out, bf16* slabs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int n_slabs = (kpad + M_KS - 1) / M_KS;
  load_slab(slabs, W, npad, kpad, 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) load_slab(slabs + ((s + 1) & 1) * NMAX * M_WST, W, npad, kpad, (s + 1) * M_KS);
    cp_async_commit();
    cp_async_wait_one();  // slab s has landed
    __syncthreads();
    const bf16* slab = slabs + (s & 1) * NMAX * M_WST;
    const int k0 = s * M_KS, kw = min(M_KS, kpad - k0);
    if (col0 < npad) {
      for (int kk = 0; kk < kw; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], in + (row0 + 16 * mi + (lane & 15)) * ist + k0 + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = col0 + 16 * nj;
          if (n < npad) {
            unsigned b[4];
            ldmatrix_x4(b, slab + (n + (lane & 7) + ((lane >> 4) << 3)) * M_WST + kk +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
              if (n + 8 < npad) mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // slab s is consumed before it is refilled
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = col0 + 8 * ni + 2 * (lane & 3);
      if (n >= npad) continue;
      const int r = row0 + 16 * mi + (lane >> 2);
      const float b0 = bias[n], b1 = bias[n + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + r * M_AST + n) = __floats2bfloat162_rn(
          softplus100(acc[mi][ni][0] + b0), softplus100(acc[mi][ni][1] + b1));
      *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * M_AST + n) = __floats2bfloat162_rn(
          softplus100(acc[mi][ni][2] + b0), softplus100(acc[mi][ni][3] + b1));
    }
}

__global__ void __launch_bounds__(M_THREADS)
sdf_mlp_bf16_kernel(const float* __restrict__ pts, long long n_pts, const bf16* __restrict__ W,
                    const float* __restrict__ B, Dims dims, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + M_TP * M_AST};
  bf16* pe = bufs[1] + M_TP * M_AST;
  bf16* slabs = pe + M_TP * M_PST;
  const long long p0 = (long long)blockIdx.x * M_TP;

  positional_encoding<bf16>(pts, n_pts, p0, M_TP, dims, pe, M_PST);
  __syncthreads();
  const bf16* in = pe;
  int in_stride = M_PST, cur = 0;
  const int L = dims.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    if ((dims.skip_mask >> l) & 1) {
      skip_concat<bf16>(bufs[cur ^ 1], M_AST, pe, M_PST, M_TP, dims.k[l], dims.d_pe);
      __syncthreads();
    }
    dense_mma(in, in_stride, dims.kpad[l], W + dims.woff[l], dims.npad[l], B + dims.boff[l],
              bufs[cur], slabs);
    __syncthreads();
    in = bufs[cur];
    in_stride = M_AST;
    cur ^= 1;
  }
  last_column<bf16>(in, M_AST, M_TP, dims.k[L - 1], W + dims.woff[L - 1],
                    B[dims.boff[L - 1]], dims.scale, p0, n_pts, out);
}

template <typename WT>
int launch(void (*kernel)(const float*, long long, const WT*, const float*, Dims, float*), int tp,
           int threads, size_t smem, const float* pts, long long n_pts, const WT* w,
           const float* b, const Dims& dims, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pts + tp - 1) / tp;
  if (blocks > 0) kernel<<<(unsigned)blocks, threads, smem, stream>>>(pts, n_pts, w, b, dims, out);
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
    // the tensor-core path reads every input column below kpad: it must
    // lie in what the previous layer wrote (or the skip concat / the PE)
    const bool skip = (skip_mask >> l) & 1;
    if (bf16_act && (kpad[l] % 16 || kpad[l] > (l == 0 ? PE_MAX : NMAX) ||
                     (hidden && (npad[l] % 8 || npad[l] < n[l])) ||
                     (skip && kpad[l] != k[l]) ||
                     (l > 0 && hidden && !skip && kpad[l] > npad[l - 1])))
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
  if (bf16_act) {
    const size_t smem = (2 * M_TP * M_AST + M_TP * M_PST + 2 * NMAX * M_WST) * sizeof(bf16);
    return launch(sdf_mlp_bf16_kernel, M_TP, M_THREADS, smem, pts, n_pts,
                  static_cast<const bf16*>(w), b, dims, out, s);
  }
  const size_t smem = (2 * F_TP * NMAX + F_TP * PE_MAX + F_KC * NMAX) * sizeof(float);
  return launch(sdf_mlp_f32_kernel, F_TP, F_THREADS, smem, pts, n_pts,
                static_cast<const float*>(w), b, dims, out, s);
}
