// The tile pass: the SDF's forward F and reverse sweep G for d sdf / d x
// over one tile of points, the second-order backward of both
// (tile_backward), the layer table the entries validate, and the tile GEMM
// (tgemm) with its weight ring, which K3 / K4 (sdf_vjp.cu), K6
// (field_fwd.cu), K7 (field_bwd.cu) and K8 / K9 (nerf_bg.cu, on a config of
// their own: 256-row ring slabs, two blocks an SM in bf16) run on.
//
// A block owns P points and runs every product of its tile in turn as a
// tile GEMM out[p][j] = sum_i A[p][i] M[j][i] (tgemm). A, the pass's
// running operand, lives in shared memory in the activation dtype (T): u in
// F, d in G, r_hat in the adjoint of G, g_tot in the backward of F, each
// colour layer's input. Each epilogue writes the layer's output over its
// input behind one barrier. M is a packed weight (W, or a packed W^T for
// the reverse products); its k-slabs stream through a cp.async ring of ST
// stages (three in the SDF pass) that runs ahead across GEMM boundaries:
// the kernel's GEMMs are listed once, in the order it runs them (Sched,
// built on the host), and the ring loads ST - 1 slabs of that list ahead
// of the one being multiplied, one barrier per slab. A value is rounded to
// T only where it becomes a GEMM operand; every sum is f32 and biases are
// added in f32. The SDF pass's config (Cfg<T>):
//  * bf16: 64 points, 8 warps of 64 x 64 output tiles (up to 255
//    registers a thread for the 128 accumulators and the epilogues' state;
//    at 16 warps the 128-register cap spilled), mma.sync m16n8k16 fed by
//    ldmatrix, 32-wide slabs.
//  * float: 32 points, 8 warps of 32 x 64, exact f32 FMA products in the
//    same fragment layout, 16-wide slabs. (Split-TF32, as K1 takes, lay
//    3x past the plain f32's error to float64 in the second-order
//    backward.)
// Device rows (float32, WMAX floats per point) are written only where a
// later pass or K5 reads them, as paired stores from the fragment layout:
// K3 and K6 write z per layer; K4 and K7 every kind K5 and their later
// passes read (u, z, d, a, r_hat, g_tot).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  int lean;  // K3, K6: z per layer only (slot l holds z_l)
  __device__ float* slot(int s, long long p0) const {
    return base + ((long long)s * rows + p0) * WMAX;
  }
  __device__ float* at(int kind, int l, long long p0) const {
    return slot(lean ? l : kind * L + l, p0);
  }
};

__device__ __forceinline__ bool is_skip(const Net& net, int l) { return (net.skip_mask >> l) & 1; }

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// softplus100 and its derivatives as computed (1 and 0 past the
// threshold); the bf16 instantiations take the fast exp / log, within ~1e-7
template <typename T> __device__ __forceinline__ float sp0(float z) { return softplus100(z); }
template <> __device__ __forceinline__ float sp0<bf16>(float z) { return softplus100_fast(z); }
template <typename T> __device__ __forceinline__ float sig100(float z) {
  return 1.0f / (1.0f + expf(-100.0f * z));
}
template <> __device__ __forceinline__ float sig100<bf16>(float z) {
  return __fdividef(1.0f, 1.0f + __expf(-100.0f * z));
}
template <typename T> __device__ __forceinline__ float sp1(float z) {
  return z * 100.0f > 20.0f ? 1.0f : sig100<T>(z);
}
// sp' and sp'' at z from one sigmoid
template <typename T> __device__ __forceinline__ void sp12(float z, float& d1, float& d2) {
  const bool past = z * 100.0f > 20.0f;
  const float s = past ? 1.0f : sig100<T>(z);
  d1 = s;
  d2 = past ? 0.0f : 100.0f * s * (1.0f - s);
}

// ------------------------------ the tile GEMM ------------------------------

// A config: P points a block, THREADS threads, warp tiles of (16 MI) x 64,
// KS-wide slabs, the operand's row stride AST (PAD past its widest row), a
// ring of ST stages of NR weight rows each. The SDF pass's is Cfg<T>.
constexpr int STAGES = 3;
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int P = 64, THREADS = 256, MI = 4, KS = 32, AST = WMAX + 8, PAD = 8;
  static constexpr int NR = NMAX, ST = STAGES;
};
template <> struct Cfg<float> {
  static constexpr int P = 32, THREADS = 256, MI = 2, KS = 16, AST = WMAX + 4, PAD = 4;
  static constexpr int NR = NMAX, ST = STAGES;
};

// A ring slab holds KS columns (64 bytes) of up to NR weight rows, row r's
// 16-byte chunk c at position c ^ ((r / 2) % 4): the 8 rows an ldmatrix (or
// the float products) read at one chunk then fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r >> 1) & 3); }
constexpr int MAXG = 64;

// one GEMM of the list: rows [0, rows) and k-columns [0, kend) of the
// packed matrix at off (row stride ldm) of weight buffer src (0: the SDF
// net's, 1: the colour head's); rows and kend are multiples of 16
struct Gemm {
  long long off;
  int ldm, rows, kend, src;
};
struct Sched {
  int n;
  Gemm g[MAXG];
};

struct StreamHdr;

// The block's shared memory: the running operand, the ring, the GEMM list
// and the per-point vectors. `spare` (ghat and pehat, which only
// tile_backward uses) holds the colour head's view input and stash before
// that.
template <typename T, class C = Cfg<T>>
struct Tile {
  unsigned char* sm;  // the block's dynamic shared memory; every part at a fixed offset
  static constexpr int P = C::P;
  static constexpr size_t A_B = (size_t)P * C::AST * sizeof(T);
  static constexpr size_t R_B = A_B + (size_t)C::ST * C::NR * C::KS * sizeof(T);
  static constexpr size_t X_B = R_B + 32 + MAXG * sizeof(Gemm);  // the caller's part from here
  __device__ T* act() const { return reinterpret_cast<T*>(sm); }  // P x AST
  __device__ T* ring() const { return reinterpret_cast<T*>(sm + A_B); }  // ST x NR x KS
  __device__ StreamHdr* hdr() const { return reinterpret_cast<StreamHdr*>(sm + R_B); }
  __device__ Gemm* sched() const { return reinterpret_cast<Gemm*>(sm + R_B + 32); }  // GEMM list
  __device__ float* f(size_t i) const { return reinterpret_cast<float*>(sm + X_B) + i; }
  __device__ float* xs() const { return f(0); }          // P x 3, x * scale
  __device__ float* dxs() const { return f(P * 3); }     // P x 3, Jpe's own x-term, then dx
  __device__ float* cg() const { return f(P * 6); }      // P x 3, the cotangent on grad
  __device__ float* aux() const { return f(P * 9); }     // P x 3, the caller's (K7: d_pts)
  __device__ float* gpe() const { return f(P * 12); }                  // P x PE_MAX, g_pe
  __device__ float* ghat() const { return f(P * (12 + PE_MAX)); }      // P x PE_MAX, Jpe c_grad
  __device__ float* pehat() const { return f(P * (12 + 2 * PE_MAX)); } // P x PE_MAX
  __device__ T* pea() const {  // P x PE_MAX, the PE in T
    return reinterpret_cast<T*>(f(P * (12 + 3 * PE_MAX)));
  }
  __device__ void* spare() const { return ghat(); }
};

template <typename T>
constexpr size_t tile_bytes() {
  return Tile<T>::X_B + (size_t)Cfg<T>::P * ((12 + 3 * PE_MAX) * sizeof(float) +
                                             PE_MAX * sizeof(T));
}
// bytes of `spare`
template <typename T>
constexpr size_t spare_bytes() { return (size_t)Cfg<T>::P * 2 * PE_MAX * sizeof(float); }

// The weight stream over the kernel's GEMM list: a ring of ST slabs,
// the loads ST - 1 slabs ahead of the products, across GEMM
// boundaries. (gi, k0) is the next slab to load and lt its count; `cur`
// counts the GEMMs begun, `ct` the slabs multiplied. The weights'
// addresses and the list's length wait in shared memory (StreamHdr) beside
// the list, so no register holds them.
struct StreamHdr {
  const void* w;   // the SDF net's packed weights
  const void* cw;  // the colour head's
  int n;
};
static_assert(sizeof(StreamHdr) <= 32, "the header's room beside the list");
template <typename T, class C = Cfg<T>>
struct Stream {
  int gi, k0, lt, cur, ct;

  __device__ void fetch(const Tile<T, C>& t) {
    constexpr int V = 16 / sizeof(T);
    const StreamHdr& h = *t.hdr();
    if (gi < h.n) {
      const Gemm gm = t.sched()[gi];
      const int chunks = min(C::KS, gm.kend - k0) / V;
      const T* src = static_cast<const T*>(gm.src ? h.cw : h.w) + gm.off + k0;
      T* st = t.ring() + (lt % C::ST) * C::NR * C::KS;
      for (int e = threadIdx.x; e < gm.rows * chunks; e += C::THREADS) {
        const int r = e / chunks, j = e - r * chunks;
        cp_async16(st + r * C::KS + V * swz(r, j), src + (long long)r * gm.ldm + V * j);
      }
      ++lt;
      k0 += C::KS;
      if (k0 >= gm.kend) k0 = 0, ++gi;
    }
    cp_async_commit();
  }
};

// Copies the list into shared memory and starts the ring; every thread
template <typename T, class C>
__device__ Stream<T, C> start_stream(const Sched& s, const T* w, const T* cw, Tile<T, C>& t) {
  for (int i = threadIdx.x; i < s.n * (int)(sizeof(Gemm) / 4); i += blockDim.x)
    reinterpret_cast<int*>(t.sched())[i] = reinterpret_cast<const int*>(s.g)[i];
  if (threadIdx.x == 0) *t.hdr() = StreamHdr{w, cw, s.n};
  __syncthreads();
  Stream<T, C> st{0, 0, 0, 0, 0};
  for (int i = 0; i < C::ST - 1; ++i) st.fetch(t);
  return st;
}

// the products of one slab (kw <= KS columns from k0) into warp (row0,
// col0)'s (16 MI) x 64 tile; with TWO, A's columns from `split` on come
// from A2
template <bool TWO, int MI>
__device__ __forceinline__ void slab_mma(const bf16* A, int ast, const bf16* A2, int a2st,
                                         int split, int k0, const bf16* slab, int kw, int rows,
                                         int row0, int col0, float (&acc)[MI][8][4]) {
  constexpr int KS = Cfg<bf16>::KS;
  const int lane = threadIdx.x & 31;
  if (col0 >= rows) return;
#pragma unroll
  for (int kk = 0; kk < Cfg<bf16>::KS; kk += 16) {
    if (kk >= kw) break;
    const int k = k0 + kk;
    const bf16* a0 = !TWO || k < split ? A + k : A2 + (k - split);
    const int st = !TWO || k < split ? ast : a2st;
    unsigned a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(a[mi], a0 + (row0 + 16 * mi + (lane & 15)) * st + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = col0 + 16 * nj;
      if (n >= rows) break;
      unsigned b[4];
      const int r = n + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, slab + r * KS + 8 * swz(r, (kk >> 3) + ((lane >> 3) & 1)));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// float: exact f32 FMA products in the mma fragment layout (c0, c1: row g,
// columns 2c, 2c + 1; c2, c3: row g + 8)
template <bool TWO, int MI>
__device__ __forceinline__ void slab_mma(const float* A, int ast, const float* A2, int a2st,
                                         int split, int k0, const float* slab, int kw, int rows,
                                         int row0, int col0, float (&acc)[MI][8][4]) {
  constexpr int KS = Cfg<float>::KS;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (col0 >= rows) return;
#pragma unroll 4
  for (int kk = 0; kk < kw; ++kk) {
    const int k = k0 + kk;
    const float* a0 = !TWO || k < split ? A + k : A2 + (k - split);
    const int st = !TWO || k < split ? ast : a2st;
    float a[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      a[mi][0] = a0[(row0 + 16 * mi + g) * st];
      a[mi][1] = a0[(row0 + 16 * mi + g + 8) * st];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = col0 + 8 * ni;
      if (n >= rows) break;
      const int r = n + 2 * c, q = kk & 3;
      const float b0 = slab[r * KS + 4 * swz(r, kk >> 2) + q];
      const float b1 = slab[(r + 1) * KS + 4 * swz(r + 1, kk >> 2) + q];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        acc[mi][ni][0] += a[mi][0] * b0;
        acc[mi][ni][1] += a[mi][0] * b1;
        acc[mi][ni][2] += a[mi][1] * b0;
        acc[mi][ni][3] += a[mi][1] * b1;
      }
    }
  }
}

// epi(p, j, v_j, v_{j+1}) over warp (row0, col0)'s accumulators, even j <
// rows; an epi that takes a fifth argument also gets the pair's index q
// among the thread's 16 MI pairs ((mi, ni, half) in order), the same in
// every tgemm over one config
template <class Epi, int MI>
__device__ __forceinline__ void epilogue(const Epi& epi, float (&acc)[MI][8][4], int rows,
                                         int row0, int col0) {
  constexpr bool FRAG = std::is_invocable_v<const Epi&, int, int, float, float, int>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int j = col0 + 8 * ni + 2 * (lane & 3);
      if (j >= rows) continue;
      const int p = row0 + 16 * mi + (lane >> 2);
      // one step's row loads at a time: hoisted further, they take
      // registers the accumulators hold, and K7 spilled more
      if constexpr (FRAG) {
        epi(p, j, acc[mi][ni][0], acc[mi][ni][1], 2 * (mi * 8 + ni));
        asm volatile("" ::: "memory");
        epi(p + 8, j, acc[mi][ni][2], acc[mi][ni][3], 2 * (mi * 8 + ni) + 1);
        asm volatile("" ::: "memory");
      } else {
        epi(p, j, acc[mi][ni][0], acc[mi][ni][1]);
        asm volatile("" ::: "memory");
        epi(p + 8, j, acc[mi][ni][2], acc[mi][ni][3]);
        asm volatile("" ::: "memory");
      }
    }
  }
}

// The next GEMM of the list over the tile: A (row stride ast; with TWO,
// columns from `split` on from A2), then epi(p, j, v_j, v_{j+1}) for every even column
// j < the GEMM's rows. Every warp has read A before any epilogue writes,
// so an epilogue may write over A; the next tgemm's first barrier orders
// the epilogue's shared-memory writes before the next reads. epi may also
// be a callable that makes the epilogue, after the products.
template <bool TWO = false, typename T, class C, class Epi>
__device__ void tgemm(Stream<T, C>& s, Tile<T, C>& t, const T* A, int ast, Epi& epi,
                      const T* A2 = nullptr, int a2st = 0, int split = 0) {
  static_assert(C::KS == Cfg<T>::KS, "slab_mma's slab width");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WR = C::P / (16 * C::MI);  // warps along the points
  const int row0 = (warp % WR) * 16 * C::MI, col0 = (warp / WR) * 64;
  const int gi = s.cur++;
  const Gemm gm = t.sched()[gi];
  float acc[C::MI][8][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int k0 = 0; k0 < gm.kend; k0 += C::KS, ++s.ct) {
    cp_async_wait<C::ST - 2>();  // this slab has landed
    __syncthreads();             // for every thread; the previous slab's stage is free
    s.fetch(t);
    slab_mma<TWO>(A, ast, A2, a2st, split, k0, t.ring() + (s.ct % C::ST) * C::NR * C::KS,
             min(C::KS, gm.kend - k0), gm.rows, row0, col0, acc);
  }
  __syncthreads();
  if constexpr (std::is_invocable_v<Epi&>) {
    const auto e = epi();  // made only now: nothing of it is live in the k loop
    epilogue(e, acc, gm.rows, row0, col0);
  } else {
    epilogue(epi, acc, gm.rows, row0, col0);
  }
}

// --------------------------- row and operand stores ---------------------------

// row[j], row[j + 1] (those below n): one 8-byte store where aligned
__device__ __forceinline__ void st2(float* row, int j, int n, float v0, float v1) {
  float* q = row + j;
  if (j + 1 < n && ((uintptr_t)q & 7) == 0) {
    *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
  } else {
    if (j < n) q[0] = v0;
    if (j + 1 < n) q[1] = v1;
  }
}
__device__ __forceinline__ float2 ld2(const float* row, int j) {
  return *reinterpret_cast<const float2*>(row + j);  // j even, rows 8-byte aligned
}
// operand columns j, j + 1 (those below n), rounded to T
__device__ __forceinline__ void at2(float* a, int j, int n, float v0, float v1) {
  st2(a, j, n, v0, v1);
}
__device__ __forceinline__ void at2(bf16* a, int j, int n, float v0, float v1) {
  if (j + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(a + j) = __floats2bfloat162_rn(v0, v1);
  } else if (j < n) {
    a[j] = __float2bfloat16(v0);
  }
}
template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_t<bf16>(float v) { return __float2bfloat16(v); }

// columns [from, to) of the tile's operand rows set to 0
template <typename T>
__device__ void zero_cols(T* act, int from, int to) {
  using C = Cfg<T>;
  const int w = to - from;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < C::P * w; e += C::THREADS) {
    const int p = e / w;
    act[p * C::AST + from + e - p * w] = to_t<T>(0.0f);
  }
}

// ------------------------------ per-point helpers ------------------------------

// channel c of [x, sin(x), cos(x), sin(2x), cos(2x), ...] for a 3-vector
__device__ __forceinline__ float pe_value(const float* x, int c) {
  if (c < 3) return x[c];
  const int i = (c - 3) / 6, r = (c - 3) - 6 * i;
  const float f = (float)(1 << i);
  return r < 3 ? sinf(f * x[r]) : cosf(f * x[r - 3]);
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

// [h, pe] / sqrt 2 for skip layer l: the PE part of its operand (columns
// dh ..) and of its device row (if given), zero up to kpad
template <typename T, typename PE>
__device__ void skip_pe(const Net& net, int l, Tile<T>& t, const PE* pe, float* row) {
  using C = Cfg<T>;
  const int dh = net.dh[l], w = net.kpad[l] - dh;
  for (int e = threadIdx.x; e < C::P * w; e += C::THREADS) {
    const int p = e / w, c = e - p * w;
    const float v = c < net.d_pe ? float(pe[p * PE_MAX + c]) * C_SKIP : 0.0f;
    t.act()[p * C::AST + dh + c] = to_t<T>(v);
    if (row && c < net.d_pe) row[(long long)p * WMAX + dh + c] = v;
  }
}

// ------------------------------ F and G ------------------------------

template <typename T>
struct FwdEpi {  // z_l = acc + b -> Z; u_{l+1} = sp(z) (times c into a skip) -> operand, U
  Tile<T> t; const float* b; float* Z; float* U; int n; float cs;
  __device__ void operator()(int p, int j, float a0, float a1) const {
    if (j >= n) return;
    const float z0 = a0 + b[j], z1 = j + 1 < n ? a1 + b[j + 1] : 0.0f;
    const float u0 = rnd<T>(sp0<T>(z0)) * cs, u1 = rnd<T>(sp0<T>(z1)) * cs;
    at2(t.act() + p * Cfg<T>::AST, j, n, u0, u1);
    st2(Z + (long long)p * WMAX, j, n, z0, z1);
    if (U) st2(U + (long long)p * WMAX, j, n, u0, u1);
  }
};

// The tile's points scaled, their PE into t.pea() (rounded) and layer 0's
// operand (and u_0's row, if with_u); g_pe zeroed
template <typename T>
__device__ void tile_pe(const float* pts, long long n_valid, const Net& net, const Work& wk,
                        long long p0, Tile<T>& t, bool with_u) {
  using C = Cfg<T>;
  float* U0 = with_u ? wk.at(KU, 0, p0) : nullptr;
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    float x[3];
    for (int a = 0; a < 3; ++a) {
      x[a] = p < n_valid ? pts[(long long)p * 3 + a] * net.scale : 0.0f;
      t.xs()[p * 3 + a] = x[a];
    }
    for (int c = 0; c < PE_MAX; ++c) {
      const float v = c < net.d_pe ? pe_value(x, c) : 0.0f;
      if (U0 && c < net.d_pe) U0[(long long)p * WMAX + c] = v;
      if (c < net.kpad[0]) t.act()[p * C::AST + c] = to_t<T>(v);
      t.pea()[p * PE_MAX + c] = to_t<T>(v);
      t.gpe()[p * PE_MAX + c] = 0.0f;
    }
  }
}

// F through layer L - 2: leaves u_{L-1} in the operand, z_l (and u_l, if
// with_u) in the rows
template <typename T>
__device__ void tile_F(const Net& net, const float* b, const Work& wk, long long p0, Stream<T>& s,
                       Tile<T>& t, bool with_u) {
  for (int l = 0; l < net.L - 1; ++l) {
    const bool skip = is_skip(net, l + 1);
    auto e = [&] { return FwdEpi<T>{t, b + net.b_off[l], wk.at(KZ, l, p0),
                with_u ? wk.at(KU, l + 1, p0) : nullptr, net.n[l], skip ? C_SKIP : 1.0f}; };
    tgemm(s, t, t.act(), Cfg<T>::AST, e);
    if (skip) skip_pe(net, l + 1, t, t.pea(), with_u ? wk.at(KU, l + 1, p0) : nullptr);
    else zero_cols(t.act(), net.n[l], net.kpad[l + 1]);
  }
}

// The last layer's output columns from NMAX on (at most WMAX - NMAX): one
// warp per (point, column), from the operand u_{L-1}; out(p, j, v) gets them
template <typename T, class Out>
__device__ void last_tail(const Net& net, const T* w, const float* b, Tile<T>& t, Out& out) {
  using C = Cfg<T>;
  const int l = net.L - 1, extra = net.n[l] - NMAX, K = net.k[l];
  if (extra <= 0) return;
  __syncthreads();  // the operand is written
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < C::P * extra; e += C::THREADS / 32) {
    const int p = e / extra, j = NMAX + e - p * extra;
    const T* wr = w + net.w_off[l] + (long long)j * net.kpad[l];
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) s += float(t.act()[p * C::AST + k]) * float(wr[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out(p, j, s + b[net.b_off[l] + j]);
  }
}

template <typename T>
struct RevEpi {  // r_l = d_l W_l -> a_l (-> A) and d_{l-1} (-> operand, D), the PE part into g_pe
  Tile<T> t; const float* Zprev; float* A; float* D; int dh, k; float cs;
  __device__ void one(int p, int i, float r) const {
    if (i < dh) {
      if (!Zprev) t.gpe()[p * PE_MAX + i] += r * cs;
    } else if (i < k) {
      t.gpe()[p * PE_MAX + i - dh] += r * C_SKIP;
    }
  }
  __device__ void operator()(int p, int i, float r0, float r1) const {
    const long long o = (long long)p * WMAX;
    if (i < dh) {
      const float a0 = r0 * cs, a1 = r1 * cs;
      if (A) st2(A + o, i, dh, a0, a1);
      if (Zprev) {
        const float2 z = i + 1 < dh ? ld2(Zprev + o, i) : make_float2(Zprev[o + i], 0.0f);
        const float d0 = a0 * sp1<T>(z.x), d1 = a1 * sp1<T>(z.y);
        at2(t.act() + p * Cfg<T>::AST, i, dh, d0, d1);
        if (D) st2(D + o, i, dh, d0, d1);
      }
    }
    if (!Zprev || i + 1 >= dh) {
      one(p, i, r0);
      one(p, i + 1, r1);
    }
  }
};

// G: d_{L-1} = e_0, so r_{L-1} is row 0 of W_{L-1}; then the reverse
// products down to layer 0, g_pe into t.gpe(). Reads z_l; writes a_l and d_l
// if with_ad. The operand is free on entry.
template <typename T>
__device__ void tile_G(const Net& net, const T* w, const Work& wk, long long p0, Stream<T>& s,
                       Tile<T>& t, bool with_ad) {
  using C = Cfg<T>;
  const int L = net.L;
  __syncthreads();  // the operand's last readers and writers are done
  {
    const int l = L - 1;
    RevEpi<T> e{t, wk.at(KZ, l - 1, p0), with_ad ? wk.at(KA, l, p0) : nullptr,
                with_ad ? wk.at(KD, l - 1, p0) : nullptr, net.dh[l], net.k[l],
                is_skip(net, l) ? C_SKIP : 1.0f};
    const T* w0 = w + net.w_off[l];
    const int hk = (net.k[l] + 1) / 2;
    for (int e2 = threadIdx.x; e2 < C::P * hk; e2 += C::THREADS) {
      const int p = e2 / hk, i = 2 * (e2 - p * hk);
      e(p, i, float(w0[i]), i + 1 < net.k[l] ? float(w0[i + 1]) : 0.0f);
    }
    zero_cols(t.act(), net.n[l - 1], net.npad[l - 1]);
  }
  for (int l = L - 2; l >= 0; --l) {
    auto e = [&] {
      return RevEpi<T>{t, l > 0 ? wk.at(KZ, l - 1, p0) : nullptr,
                       with_ad ? wk.at(KA, l, p0) : nullptr,
                       with_ad && l > 0 ? wk.at(KD, l - 1, p0) : nullptr, net.dh[l], net.k[l],
                       is_skip(net, l) ? C_SKIP : 1.0f};
    };
    tgemm(s, t, t.act(), C::AST, e);
    if (l > 0) zero_cols(t.act(), net.n[l - 1], net.npad[l - 1]);
  }
  __syncthreads();
}

// ------------------------- the second-order backward -------------------------

template <typename T>
struct BupEpi {  // a_hat = r_hat_l W_l^T, the cotangent on d_l -> z2_l (G), r_hat_{l+1}
  Tile<T> t; float* G; const float* Anext; const float* Z; float* R; int n; float cs;
  __device__ void operator()(int p, int j, float h0, float h1) const {
    if (j >= n) return;
    const long long o = (long long)p * WMAX;
    const bool two = j + 1 < n;
    const float2 z = two ? ld2(Z + o, j) : make_float2(Z[o + j], 0.0f);
    const float2 a = two ? ld2(Anext + o, j) : make_float2(Anext[o + j], 0.0f);
    float d0, d1, e0, e1;  // sp' and sp'' at z
    sp12<T>(z.x, d0, e0);
    sp12<T>(z.y, d1, e1);
    st2(G + o, j, n, h0 * a.x * e0, h1 * a.y * e1);
    const float r0 = h0 * d0 * cs, r1 = h1 * d1 * cs;
    st2(R + o, j, n, r0, r1);
    at2(t.act() + p * Cfg<T>::AST, j, n, r0, r1);
  }
};

template <typename T>
struct TdEpi {  // beta = g_tot_l W_l -> g_tot_{l-1} (z2_{l-1} + ..., operand and G) or pe_hat
  Tile<T> t; float* Gprev; const float* Zprev; int dh, k; float cs;
  __device__ void one(int p, int i, float beta) const {
    if (i < dh) {
      if (!Gprev) t.pehat()[p * PE_MAX + i] += beta * cs;
    } else if (i < k) {
      t.pehat()[p * PE_MAX + i - dh] += beta * C_SKIP;
    }
  }
  __device__ void operator()(int p, int i, float b0, float b1) const {
    if (Gprev && i < dh) {
      const long long o = (long long)p * WMAX;
      const bool two = i + 1 < dh;
      const float2 z = two ? ld2(Zprev + o, i) : make_float2(Zprev[o + i], 0.0f);
      const float2 g = two ? ld2(Gprev + o, i) : make_float2(Gprev[o + i], 0.0f);
      const float g0 = g.x + b0 * cs * sp1<T>(z.x), g1 = g.y + b1 * cs * sp1<T>(z.y);
      st2(Gprev + o, i, dh, g0, g1);
      at2(t.act() + p * Cfg<T>::AST, i, dh, g0, g1);
      if (two) return;
      one(p, i + 1, b1);
      return;
    }
    one(p, i, b0);
    one(p, i + 1, b1);
  }
};

// After tile_F and tile_G into a full workspace (every kind per layer) and
// the cotangents: c_out, already in the tile's g_tot rows of the last
// layer (zero rows past the tile's points), and c_grad in t.cg(). The adjoint
// of G bottom-up (the z2 second-order cotangents), the backward of F
// top-down with z2 injected, and the PE terms. Leaves per layer the dW
// factor pairs (d_l, r_hat_l) and (g_tot_l, u_l) in the workspace and dx
// (scaled) in t.dxs().
template <typename T>
__device__ void tile_backward(const Net& net, const Work& wk, long long p0, Stream<T>& s,
                              Tile<T>& t) {
  using C = Cfg<T>;
  const int L = net.L, n_last = net.n[L - 1];
  // the PE terms of the adjoint of G: ghat_pe = Jpe c_grad (also r_hat_0)
  // and the x-dependence of Jpe; d_{L-1} = e_0
  float* R0 = wk.at(KR, 0, p0);
  float* DL = wk.at(KD, L - 1, p0);
  __syncthreads();
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    const float* xs = t.xs() + p * 3;
    float* gh = t.ghat() + p * PE_MAX;
    const float* gp = t.gpe() + p * PE_MAX;
    for (int a = 0; a < 3; ++a) {
      const float cg = t.cg()[p * 3 + a];
      gh[a] = cg;
      float dxs = 0.0f, f = 1.0f;
      for (int i = 0; i < net.multires; ++i, f *= 2.0f) {
        const float sn = sinf(f * xs[a]), cs = cosf(f * xs[a]);
        gh[3 + 6 * i + a] = cg * f * cs;
        gh[6 + 6 * i + a] = -cg * f * sn;
        dxs -= (gp[3 + 6 * i + a] * sn + gp[6 + 6 * i + a] * cs) * (f * f) * cg;
      }
      t.dxs()[p * 3 + a] = dxs;
    }
    for (int c = 0; c < PE_MAX; ++c) {
      const float v = c < net.d_pe ? gh[c] : 0.0f;
      if (c < net.d_pe) R0[(long long)p * WMAX + c] = v;
      if (c < net.kpad[0]) t.act()[p * C::AST + c] = to_t<T>(v);
      t.pehat()[p * PE_MAX + c] = 0.0f;
    }
    for (int j = 0; j < n_last; ++j) DL[(long long)p * WMAX + j] = j == 0 ? 1.0f : 0.0f;
  }

  // adjoint of G, bottom-up
  for (int l = 0; l < L - 1; ++l) {
    const bool skip = is_skip(net, l + 1);
    auto e = [&] {
      return BupEpi<T>{t, wk.at(KG, l, p0), wk.at(KA, l + 1, p0), wk.at(KZ, l, p0),
                       wk.at(KR, l + 1, p0), net.n[l], skip ? C_SKIP : 1.0f};
    };
    tgemm(s, t, t.act(), C::AST, e);
    if (skip) skip_pe(net, l + 1, t, t.ghat(), wk.at(KR, l + 1, p0));
    else zero_cols(t.act(), net.n[l], net.kpad[l + 1]);
  }
  __syncthreads();
  // g_tot_{L-1} from its row into the operand
  {
    const float* GL = wk.at(KG, L - 1, p0);
    const int np = net.npad[L - 1];
    for (int e = threadIdx.x; e < C::P * np; e += C::THREADS) {
      const int p = e / np, j = e - p * np;
      t.act()[p * C::AST + j] = to_t<T>(j < n_last ? GL[(long long)p * WMAX + j] : 0.0f);
    }
  }
  // backward of F, top-down, z2 already in G
  for (int l = L - 1; l >= 0; --l) {
    auto e = [&] {
      return TdEpi<T>{t, l > 0 ? wk.at(KG, l - 1, p0) : nullptr,
                      l > 0 ? wk.at(KZ, l - 1, p0) : nullptr, net.dh[l], net.k[l],
                      is_skip(net, l) ? C_SKIP : 1.0f};
    };
    tgemm(s, t, t.act(), C::AST, e);
    if (l > 0) zero_cols(t.act(), net.n[l - 1], net.npad[l - 1]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    float g[3];
    pe_jac_T(t.xs() + p * 3, net.multires, t.pehat() + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) t.dxs()[p * 3 + a] = (t.dxs()[p * 3 + a] + g[a]) * net.scale;
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

// The GEMM list, in the order a kernel runs its products
struct SchedMaker {
  Sched s{};
  bool ok = true;
  int maxrows = NMAX;  // the ring's rows (C::NR)
  void add(int src, long long off, int ldm, int rows, int kend) {
    if (s.n >= MAXG || rows <= 0 || rows > maxrows || rows % 16 || kend % 16) {
      ok = false;
      return;
    }
    s.g[s.n++] = Gemm{off, ldm, rows, kend, src};
  }
  void F(const Net& n) {  // layers 0 .. L - 2 (tile_F)
    for (int l = 0; l < n.L - 1; ++l) add(0, n.w_off[l], n.kpad[l], n.npad[l], n.kpad[l]);
  }
  void last(const Net& n) {  // the last layer's first NMAX outputs
    const int l = n.L - 1;
    add(0, n.w_off[l], n.kpad[l], n.npad[l] < NMAX ? n.npad[l] : NMAX, n.kpad[l]);
  }
  void G(const Net& n) {  // layers L - 2 .. 0 through W^T (tile_G)
    for (int l = n.L - 2; l >= 0; --l) add(0, n.wt_off[l], n.npad[l], n.kpad[l], n.npad[l]);
  }
  void backward(const Net& n) {  // tile_backward
    for (int l = 0; l < n.L - 1; ++l) add(0, n.w_off[l], n.kpad[l], n.npad[l], n.kpad[l]);
    for (int l = n.L - 1; l >= 0; --l) add(0, n.wt_off[l], n.npad[l], n.kpad[l], n.npad[l]);
  }
};

// A kernel's launch attributes before its launch: its dynamic shared memory
// and, with max_carveout, the largest shared-memory carveout. Neither call
// is a stream operation, so a launch inside a CUDA graph capture sets them
// as an eager one does.
template <typename K>
int prepare(K kernel, size_t smem, bool max_carveout = false) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err && max_carveout)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace
