// The SDF tile pass shared by K3 / K4 (sdf_vjp.cu), K6 (field_fwd.cu) and
// K7 (field_bwd.cu): the per-layer tile GEMMs with fused epilogues, the
// forward F and the reverse sweep G for d sdf / d x over one tile of
// points, the second-order backward of both (tile_backward), and the layer
// table the entries validate. K8 / K9 (nerf_bg.cu) use the tile GEMMs.
//
// A block owns P points and runs every layer of its tile in turn as a tile
// GEMM out[p][j] = sum_i A[p][i] M[j][i]: A comes from the block's own rows
// of a float32 workspace in device memory, M is a packed weight (W, or a
// packed W^T for the reverse products), both staged through shared memory
// in k-slabs; GEMM operands are rounded to the activation dtype as they are
// staged, everything else stays f32. bf16: 64 points, 16 warps, mma.sync
// m16n8k16 with f32 accumulation; float: 32 points, 8 warps, FMA.
//
// The workspace holds rows of WMAX floats per point for each (kind, layer)
// the sweeps name. K3 / K4 keep every kind per layer (u, z, d, a, and the
// backward's r_hat, g_tot); K6 keeps only z per layer and two rows each
// for u and d, in turns (Work::lean).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace nw;

constexpr int MAXL = 16;
constexpr int NMAX = 512;   // widest GEMM output of one tile pass
constexpr int WMAX = 528;   // workspace row stride (>= 513, a multiple of 16)
constexpr int PE_MAX = 64;
constexpr float C_SKIP = 0.70710678118654752440f;
enum Kind { KU = 0, KZ, KD, KA, KR, KG };

struct Net {
  int L, multires, d_pe, skip_mask;
  float scale;
  int k[MAXL], n[MAXL], dh[MAXL], kpad[MAXL], npad[MAXL], b_off[MAXL];
  long long w_off[MAXL], wt_off[MAXL];
};

struct Work {
  float* base;
  long long rows;  // rows of every slot
  int L;
  int lean;  // K6: z per layer (slots 0 .. L-2), u in L-1 / L, d (and a) in L+1 / L+2
  __device__ float* slot(int s, long long p0) const {
    return base + ((long long)s * rows + p0) * WMAX;
  }
  __device__ float* at(int kind, int l, long long p0) const {
    if (!lean) return slot(kind * L + l, p0);
    // a_l is written and never read: it shares d_l's row, whose GEMM
    // operand is fully staged before the epilogue writes
    const int s = kind == KZ ? l : kind == KU ? L - 1 + (l & 1) : L + 1 + (l & 1);
    return slot(s, p0);
  }
};

__device__ __forceinline__ bool is_skip(const Net& net, int l) { return (net.skip_mask >> l) & 1; }

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the derivatives of softplus100 as computed: 1 and 0 past the threshold
__device__ __forceinline__ float sp1(float z) {
  return z * 100.0f > 20.0f ? 1.0f : 1.0f / (1.0f + expf(-100.0f * z));
}
__device__ __forceinline__ float sp2(float z) {
  if (z * 100.0f > 20.0f) return 0.0f;
  const float s = 1.0f / (1.0f + expf(-100.0f * z));
  return 100.0f * s * (1.0f - s);
}

// ------------------------------ tile GEMMs ------------------------------
// out[p][j] = sum_{i < K} A[p * WMAX + i] * M[j * ldm + i] for the tile's
// rows p and j < N (N <= NMAX); epi(p, j, acc) gets every element. The
// packed M has zero rows up to round_up(N, 16) and zero columns up to ldm.
// A is read only while it is staged, before the last barrier of the k
// loop, so an epilogue may overwrite A's rows.

constexpr int F_P = 32, F_THREADS = 256, F_KC = 16;

template <class Epi>
__device__ void gemm(const float* A, int K, const float* M, int ldm, int N, float* sm, Epi& epi) {
  float* As = sm;                 // F_P x F_KC
  float* Ms = sm + F_P * F_KC;    // F_KC x NMAX, transposed
  const int tid = threadIdx.x, c = tid & 63, g = tid >> 6;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += F_KC) {
    __syncthreads();
    for (int e = tid; e < F_P * F_KC; e += F_THREADS) {
      const int p = e / F_KC, kk = e - p * F_KC;
      As[e] = k0 + kk < K ? A[(long long)p * WMAX + k0 + kk] : 0.0f;
    }
    for (int col = tid; col < NMAX; col += F_THREADS) {
      const float* src = M + (long long)col * ldm + k0;
      for (int r = 0; r < F_KC; ++r) Ms[r * NMAX + col] = (col < N && k0 + r < K) ? src[r] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < F_KC; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(&Ms[kk * NMAX + 4 * c]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ms[kk * NMAX + 256 + 4 * c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(g * 8 + i) * F_KC + kk];
        acc[i][0] += a * w0.x; acc[i][1] += a * w0.y; acc[i][2] += a * w0.z; acc[i][3] += a * w0.w;
        acc[i][4] += a * w1.x; acc[i][5] += a * w1.y; acc[i][6] += a * w1.z; acc[i][7] += a * w1.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 4 * c : 256 + 4 * c) + (j & 3);
      if (col < N) epi(g * 8 + i, col, acc[i][j]);
    }
  __syncthreads();
}

constexpr int M_P = 64, M_THREADS = 512, M_KS = 32, M_ST = M_KS + 8;

template <class Epi>
__device__ void gemm(const float* A, int K, const bf16* M, int ldm, int N, float* smf, Epi& epi) {
  bf16* As = reinterpret_cast<bf16*>(smf);  // M_P x M_ST
  bf16* Ms = As + M_P * M_ST;               // NMAX x M_ST
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 64;
  const int nrows = (N + 15) & ~15, kend = (K + 15) & ~15;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int k0 = 0; k0 < kend; k0 += M_KS) {
    const int kw = min(M_KS, kend - k0);
    __syncthreads();
    for (int e = tid; e < M_P * M_KS; e += M_THREADS) {
      const int p = e / M_KS, kk = e - p * M_KS;
      As[p * M_ST + kk] = __float2bfloat16(k0 + kk < K ? A[(long long)p * WMAX + k0 + kk] : 0.0f);
    }
    const int chunks = kw / 8;
    for (int e = tid; e < nrows * chunks; e += M_THREADS) {
      const int r = e / chunks, j = e - r * chunks;
      *reinterpret_cast<uint4*>(Ms + r * M_ST + 8 * j) =
          *reinterpret_cast<const uint4*>(M + (long long)r * ldm + k0 + 8 * j);
    }
    __syncthreads();
    if (col0 < nrows) {
      for (int kk = 0; kk < kw; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], As + (row0 + 16 * mi + (lane & 15)) * M_ST + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int nb = col0 + 16 * nj;
          if (nb < nrows) {
            unsigned b[4];
            ldmatrix_x4(b, Ms + (nb + (lane & 7) + ((lane >> 4) << 3)) * M_ST + kk +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * ni + 2 * (lane & 3) + (e & 1);
        if (col < N) epi(row0 + 16 * mi + (lane >> 2) + (e >> 1) * 8, col, acc[mi][ni][e]);
      }
  __syncthreads();
}

// ------------------------------ epilogues ------------------------------

template <typename T>
struct FwdEpi {  // z_l = acc + b; h = sp(z) feeds layer l + 1 (times c into a skip)
  const float* b; float* Z; float* Unext; float cs;
  __device__ void operator()(int p, int j, float acc) const {
    const float z = acc + b[j];
    Z[(long long)p * WMAX + j] = z;
    Unext[(long long)p * WMAX + j] = rnd<T>(softplus100(z)) * cs;
  }
};

struct OutEpi {  // the last layer: out = z, for the tile's first n_valid rows
  const float* b; float* out; int ldo, jofs; long long n_valid;
  __device__ void operator()(int p, int j, float acc) const {
    if (p < n_valid) out[(long long)p * ldo + jofs + j] = acc + b[jofs + j];
  }
};

struct RevEpi {  // r_l = d_l W_l -> a_l (and d_{l-1}), the PE part into g_pe
  float* Aout; float* Dprev; const float* Zprev; float* gpe; int dh; float cs;
  __device__ void operator()(int p, int i, float r) const {
    const long long o = (long long)p * WMAX + i;
    if (i < dh) {
      const float a = r * cs;
      Aout[o] = a;
      if (Dprev) Dprev[o] = a * sp1(Zprev[o]);
      else gpe[p * PE_MAX + i] += a;
    } else {
      gpe[p * PE_MAX + i - dh] += r * C_SKIP;
    }
  }
};

// ------------------------------ tile passes ------------------------------

struct Tile {
  float* xs;    // P x 3, x * scale
  float* dxs;   // P x 3, the x-cotangent of Jpe's own x-dependence, then dx
  float* cg;    // P x 3, the cotangent on grad that tile_backward takes
  float* aux;   // P x 3, the caller's (K7: the colour head's d_pts)
  float* pea;   // P x PE_MAX, PE rounded to the activation dtype
  float* gpe;   // P x PE_MAX, g_pe
  float* ghat;  // P x PE_MAX, Jpe c_grad
  float* pehat; // P x PE_MAX
  float* gemm;  // GEMM staging
};

// channel c of [x, sin(x), cos(x), sin(2x), cos(2x), ...] for a 3-vector
__device__ __forceinline__ float pe_value(const float* x, int c) {
  if (c < 3) return x[c];
  const int i = (c - 3) / 6, r = (c - 3) - 6 * i;
  const float f = (float)(1 << i);
  return r < 3 ? sinf(f * x[r]) : cosf(f * x[r - 3]);
}

// F for the tile (through layer L - 2, or L - 1 into out) and G -> t.gpe
template <typename T, int P>
__device__ void tile_forward(const float* pts, long long n_valid, const Net& net, const T* w,
                             const float* b, const Work& wk, long long p0, Tile& t,
                             float* out) {
  const int L = net.L;
  float* U0 = wk.at(KU, 0, p0);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float x[3];
    for (int a = 0; a < 3; ++a) {
      x[a] = p < n_valid ? pts[(long long)p * 3 + a] * net.scale : 0.0f;
      t.xs[p * 3 + a] = x[a];
    }
    for (int c = 0; c < PE_MAX; ++c) {
      const float v = c < net.d_pe ? pe_value(x, c) : 0.0f;
      if (c < net.d_pe) U0[(long long)p * WMAX + c] = v;
      t.pea[p * PE_MAX + c] = rnd<T>(v);
      t.gpe[p * PE_MAX + c] = 0.0f;
    }
  }
  __syncthreads();
  for (int l = 0; l < L - 1; ++l) {
    FwdEpi<T> e{b + net.b_off[l], wk.at(KZ, l, p0), wk.at(KU, l + 1, p0),
                is_skip(net, l + 1) ? C_SKIP : 1.0f};
    gemm(wk.at(KU, l, p0), net.k[l], w + net.w_off[l], net.kpad[l], net.n[l], t.gemm, e);
    if (is_skip(net, l + 1)) {
      float* U = wk.at(KU, l + 1, p0) + net.dh[l + 1];
      for (int e2 = threadIdx.x; e2 < P * net.d_pe; e2 += blockDim.x) {
        const int p = e2 / net.d_pe, c = e2 - p * net.d_pe;
        U[(long long)p * WMAX + c] = t.pea[p * PE_MAX + c] * C_SKIP;
      }
      __syncthreads();
    }
  }
  if (out) {
    const int l = L - 1;
    for (int j0 = 0; j0 < net.n[l]; j0 += NMAX) {
      OutEpi e{b + net.b_off[l], out, net.n[l], j0, n_valid};
      gemm(wk.at(KU, l, p0), net.k[l], w + net.w_off[l] + (long long)j0 * net.kpad[l],
           net.kpad[l], min(NMAX, net.n[l] - j0), t.gemm, e);
    }
  }
  // G: d_{L-1} = e_0, so r_{L-1} is row 0 of W_{L-1}
  {
    const int l = L - 1;
    RevEpi e{wk.at(KA, l, p0), wk.at(KD, l - 1, p0), wk.at(KZ, l - 1, p0), t.gpe, net.dh[l],
             is_skip(net, l) ? C_SKIP : 1.0f};
    const T* w0 = w + net.w_off[l];
    for (int e2 = threadIdx.x; e2 < P * net.k[l]; e2 += blockDim.x) {
      const int p = e2 / net.k[l], i = e2 - p * net.k[l];
      e(p, i, rnd<T>(float(w0[i])));
    }
    __syncthreads();
  }
  for (int l = L - 2; l >= 0; --l) {
    RevEpi e{wk.at(KA, l, p0), l > 0 ? wk.at(KD, l - 1, p0) : nullptr,
             l > 0 ? wk.at(KZ, l - 1, p0) : nullptr, t.gpe, net.dh[l],
             is_skip(net, l) ? C_SKIP : 1.0f};
    gemm(wk.at(KD, l, p0), net.n[l], w + net.wt_off[l], net.npad[l], net.k[l], t.gemm, e);
  }
}

// Jpe(xs)^T v for one point
__device__ __forceinline__ void pe_jac_T(const float* xs, int multires, const float* v,
                                         float* out) {
  for (int a = 0; a < 3; ++a) {
    float s = v[a], f = 1.0f;
    for (int i = 0; i < multires; ++i, f *= 2.0f)
      s += v[3 + 6 * i + a] * f * cosf(f * xs[a]) - v[6 + 6 * i + a] * f * sinf(f * xs[a]);
    out[a] = s;
  }
}

template <typename T, int P>
__device__ void tile_smem(float* sm, Tile& t) {
  t.xs = sm;
  t.dxs = sm + P * 3;
  t.cg = sm + P * 6;
  t.aux = sm + P * 9;
  t.pea = sm + P * 12;
  t.gpe = t.pea + P * PE_MAX;
  t.ghat = t.gpe + P * PE_MAX;
  t.pehat = t.ghat + P * PE_MAX;
  t.gemm = t.pehat + P * PE_MAX;
}

template <typename T, int P>
size_t smem_bytes() {
  const size_t tile = (size_t)P * (12 + 4 * PE_MAX) * sizeof(float);
  const size_t g = sizeof(T) == 4 ? (size_t)(F_P * F_KC + F_KC * NMAX) * sizeof(float)
                                  : (size_t)(M_P + NMAX) * M_ST * sizeof(bf16);
  return tile + g;
}

// ------------------------- the second-order backward -------------------------

struct BupEpi {  // a_hat = r_hat_l W_l^T is the cotangent on d_l
  float* G; const float* Anext; const float* Z; float* Rnext; float cs;
  __device__ void operator()(int p, int j, float dhat) const {
    const long long o = (long long)p * WMAX + j;
    const float z = Z[o];
    G[o] = dhat * Anext[o] * sp2(z);   // z2_l
    Rnext[o] = dhat * sp1(z) * cs;     // r_hat_{l+1}, h part
  }
};

struct TdEpi {  // beta = g_tot_l W_l -> gamma_{l-1} (added onto z2_{l-1}) or pe_hat
  float* Gprev; const float* Zprev; float* pehat; int dh; float cs;
  __device__ void operator()(int p, int i, float beta) const {
    const long long o = (long long)p * WMAX + i;
    if (i < dh) {
      const float hh = beta * cs;
      if (Gprev) Gprev[o] += hh * sp1(Zprev[o]);
      else pehat[p * PE_MAX + i] += hh;
    } else {
      pehat[p * PE_MAX + i - dh] += beta * C_SKIP;
    }
  }
};

// After tile_forward (into a full workspace, every kind per layer): the
// adjoint of G bottom-up (the z2 second-order cotangents), the backward of
// F top-down with z2 injected, and the PE terms, for the cotangents c_out,
// already in the tile's g_tot rows of the last layer (zero rows past the
// tile's points), and c_grad in t.cg. Leaves per layer the dW factor pairs
// (d_l, r_hat_l) and (g_tot_l, u_l) in the workspace and dx (scaled) in
// t.dxs.
template <typename T, int P>
__device__ void tile_backward(const Net& net, const T* w, const Work& wk, long long p0, Tile& t) {
  const int L = net.L, n_last = net.n[L - 1];
  // the PE terms of the adjoint of G: ghat_pe = Jpe c_grad (also r_hat_0)
  // and the x-dependence of Jpe; d_{L-1} = e_0
  float* R0 = wk.at(KR, 0, p0);
  float* DL = wk.at(KD, L - 1, p0);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float* xs = t.xs + p * 3;
    for (int a = 0; a < 3; ++a) {
      const float cg = t.cg[p * 3 + a];
      float* gh = t.ghat + p * PE_MAX;
      const float* gp = t.gpe + p * PE_MAX;
      gh[a] = cg;
      float dxs = 0.0f, f = 1.0f;
      for (int i = 0; i < net.multires; ++i, f *= 2.0f) {
        const float s = sinf(f * xs[a]), c = cosf(f * xs[a]);
        gh[3 + 6 * i + a] = cg * f * c;
        gh[6 + 6 * i + a] = -cg * f * s;
        dxs -= (gp[3 + 6 * i + a] * s + gp[6 + 6 * i + a] * c) * (f * f) * cg;
      }
      t.dxs[p * 3 + a] = dxs;
    }
    for (int c = 0; c < net.d_pe; ++c) {
      R0[(long long)p * WMAX + c] = t.ghat[p * PE_MAX + c];
      t.pehat[p * PE_MAX + c] = 0.0f;
    }
    for (int j = 0; j < n_last; ++j) DL[(long long)p * WMAX + j] = j == 0 ? 1.0f : 0.0f;
  }
  __syncthreads();

  // adjoint of G, bottom-up
  for (int l = 0; l < L - 1; ++l) {
    BupEpi e{wk.at(KG, l, p0), wk.at(KA, l + 1, p0), wk.at(KZ, l, p0), wk.at(KR, l + 1, p0),
             is_skip(net, l + 1) ? C_SKIP : 1.0f};
    gemm(wk.at(KR, l, p0), net.k[l], w + net.w_off[l], net.kpad[l], net.n[l], t.gemm, e);
    if (is_skip(net, l + 1)) {
      float* R = wk.at(KR, l + 1, p0) + net.dh[l + 1];
      for (int e2 = threadIdx.x; e2 < P * net.d_pe; e2 += blockDim.x) {
        const int p = e2 / net.d_pe, c = e2 - p * net.d_pe;
        R[(long long)p * WMAX + c] = t.ghat[p * PE_MAX + c] * C_SKIP;
      }
      __syncthreads();
    }
  }
  // backward of F, top-down, z2 already in G
  for (int l = L - 1; l >= 0; --l) {
    TdEpi e{l > 0 ? wk.at(KG, l - 1, p0) : nullptr, l > 0 ? wk.at(KZ, l - 1, p0) : nullptr,
            t.pehat, net.dh[l], is_skip(net, l) ? C_SKIP : 1.0f};
    gemm(wk.at(KG, l, p0), net.n[l], w + net.wt_off[l], net.npad[l], net.k[l], t.gemm, e);
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float g[3];
    pe_jac_T(t.xs + p * 3, net.multires, t.pehat + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) t.dxs[p * 3 + a] = (t.dxs[p * 3 + a] + g[a]) * net.scale;
  }
  __syncthreads();
}

// ------------------------------ host side ------------------------------

int make_net(int n_layers, int multires, float scale, int skip_mask, const int* k, const int* n,
             const int* kpad, const int* npad, const long long* w_off, const long long* wt_off,
             const int* b_off, Net* net) {
  if (n_layers < 2 || n_layers > MAXL || multires < 0 || 3 * (1 + 2 * multires) > PE_MAX ||
      (skip_mask & 1) || (skip_mask >> (n_layers - 1)))
    return -1;
  net->L = n_layers;
  net->multires = multires;
  net->d_pe = 3 * (1 + 2 * multires);
  net->skip_mask = skip_mask;
  net->scale = scale;
  for (int l = 0; l < n_layers; ++l) {
    const bool skip = (skip_mask >> l) & 1;
    const int dh = skip ? k[l] - net->d_pe : k[l];
    if (k[l] > NMAX || n[l] > (l == n_layers - 1 ? WMAX : NMAX) || dh <= 0 ||
        kpad[l] != ((k[l] + 15) & ~15) || npad[l] != ((n[l] + 15) & ~15) ||
        (l == 0 && k[l] != net->d_pe) || (l > 0 && n[l - 1] != dh) || w_off[l] % 8 ||
        wt_off[l] % 8)
      return -1;
    net->k[l] = k[l];
    net->n[l] = n[l];
    net->dh[l] = dh;
    net->kpad[l] = kpad[l];
    net->npad[l] = npad[l];
    net->w_off[l] = w_off[l];
    net->wt_off[l] = wt_off[l];
    net->b_off[l] = b_off[l];
  }
  return 0;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
