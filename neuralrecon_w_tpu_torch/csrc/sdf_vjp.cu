// K3, K4, K5: the SDF forward with its input gradient, and the hand-derived
// second-order backward of both.
//
// Replaces the TPU kernels ops/pallas_field_vjp.py:sdf_fwd_pallas (K3) and
// sdf_bwd_pallas (K4 + K5), the custom VJP that SDF_GRAD_MODE="pallas"
// trains through. The math is ops/field_vjp_math.py (the port's plain
// version, which these kernels are held to): forward F and the reverse
// sweep G for d sdf / d x; then the adjoint of G bottom-up (the z2
// second-order cotangents with sp''), the backward of F top-down with z2
// injected, and the PE terms.
//
// What bounds them, by the counts, at the 8 x 512 width: K3 ~8 MFLOP a
// point (F with the 513-wide last layer, G) against 12 bytes in and ~2 KB
// out (the 513-wide out), 2.0 ms per 245,760 points at the bf16 peak; its
// z rows (8 x 2 KB a point) are written and read back once. K4 ~15.5 MFLOP
// a point (3.8 ms), and it must write the factor rows K5 reads: 6 kinds x 9
// layers x ~512 used floats, ~110 KB a point, 27 GB per 245,760 points,
// ~8 ms at 3.35 TB/s: the rows bound K4, then the products.
//
// The design (sdf_tile.cuh): one block per tile of points (bf16: 64
// points, 8 warps of 64 x 64 output tiles, mma.sync m16n8k16; float: 32
// points, 8 warps, f32 FMA). The running operand of each pass stays in
// shared memory in the activation dtype, each layer's output written over
// its input behind one barrier; the weight k-slabs of every product of the
// kernel stream through one three-stage cp.async ring that runs ahead across
// products. Rows go to the float32 workspace only where a later pass or K5
// reads them, as paired stores from the fragment layout.
//  * K3 (nw_sdf_vjp_fwd): F and G per tile -> out (N, d_out), grad (N, 3);
//    its workspace holds z per hidden layer only.
//  * K4 (nw_sdf_vjp_bwd): recomputes F and G, runs the adjoint of G and the
//    backward of F, writes dx and leaves per layer the dW factor pairs
//    (d_l, r_hat_l) and (g_tot_l, u_l) in the workspace.
//  * K5 (nw_sdf_vjp_reduce): dW_l = d_l^T r_hat_l + g_tot_l^T u_l and
//    db_l = sum g_tot_l over the points. It only reads: the f32 factor rows
//    once (5.1 ms at 245,760 points on the H100's 3.35 TB/s) against ~2.3
//    ms of bf16 tensor-core products, so bytes bound it. A split-K GEMM
//    over the points (the K5 section below): 256 x 128 dW tiles, which read
//    each factor row 3x through L2 at the 512 width (a 64 x 64 tile read it
//    8x); coalesced 16-byte cp.async copies three slabs ahead of the
//    products; db summed in the same pass; one atomic pass per block.
//    Fusing the reduction into K4 per tile is ruled out: a 64-point tile
//    touches every dW of the 9 layers, ~2.4 M f32 atomics per tile.
// Shared memory of K3 / K4: 228,896 bytes in bf16, 202,272 in float (the
// operand, the ring, the GEMM list, the per-point PE vectors); registers
// and spills in PERF.md (ptxas -v, printed by chip_smoke.py).
// The TPU kernel's split of the layer set over two calls (VMEM could not
// hold the weights and all dW accumulators) has no counterpart: dW is
// reduced outside the per-tile kernel. The wrapper runs K3 and K4 + K5 over
// point chunks so the workspace stays a few GB. K7 and K9 reduce their dW
// factor pairs through K5 too (nw_dw_reduce, one pair per call).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf_tile.cuh"

namespace {

// K3
struct OutEpi {  // the last layer's output columns, for the tile's real points
  const float* b; float* out; int ld, n; long long n_valid;
  __device__ void operator()(int p, int j, float a0, float a1) const {
    if (p < n_valid)
      st2(out + (long long)p * ld, j, n, a0 + b[j], j + 1 < n ? a1 + b[j + 1] : 0.0f);
  }
};

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
sdf_vjp_fwd_kernel(const float* __restrict__ pts, long long n_pts, const T* __restrict__ w,
                   const float* __restrict__ b, Net net, Sched sched, Work wk,
                   float* __restrict__ out, float* __restrict__ grad) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<T> t{smem};
  Stream<T> s = start_stream(sched, w, w, t);
  const int L = net.L, n_last = net.n[L - 1];
  const long long p0 = (long long)blockIdx.x * C::P;
  const long long n_valid = n_pts - p0;
  float* o = out + p0 * n_last;
  tile_pe(pts + p0 * 3, n_valid, net, wk, p0, t, false);
  tile_F(net, b, wk, p0, s, t, false);
  auto tail = [&](int p, int j, float v) {
    if (p < n_valid) o[(long long)p * n_last + j] = v;
  };
  last_tail(net, w, b, t, tail);
  auto e = [&] {
    return OutEpi{b + net.b_off[L - 1], o, n_last, n_last < NMAX ? n_last : NMAX, n_valid};
  };
  tgemm(s, t, t.act(), C::AST, e);
  tile_G(net, w, wk, p0, s, t, false);
  for (int p = threadIdx.x; p < C::P && p < n_valid; p += C::THREADS) {
    float g[3];
    pe_jac_T(t.xs() + p * 3, net.multires, t.gpe() + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) grad[(p0 + p) * 3 + a] = g[a];
  }
}

// K4
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
sdf_vjp_bwd_kernel(const float* __restrict__ pts, long long n_pts, const float* __restrict__ c_out,
                   const float* __restrict__ c_grad, const T* __restrict__ w,
                   const float* __restrict__ b, Net net, Sched sched, Work wk,
                   float* __restrict__ dx) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<T> t{smem};
  Stream<T> s = start_stream(sched, w, w, t);
  const int L = net.L, n_last = net.n[L - 1];
  const long long p0 = (long long)blockIdx.x * C::P;
  const long long n_valid = n_pts - p0;
  // the cotangents into the tile: g_tot_{L-1} = c_out, c_grad
  float* GL = wk.at(KG, L - 1, p0);
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    for (int a = 0; a < 3; ++a) t.cg()[p * 3 + a] = p < n_valid ? c_grad[(p0 + p) * 3 + a] : 0.0f;
    for (int j = 0; j < n_last; ++j)
      GL[(long long)p * WMAX + j] = p < n_valid ? c_out[(p0 + p) * n_last + j] : 0.0f;
  }
  tile_pe(pts + p0 * 3, n_valid, net, wk, p0, t, true);
  tile_F(net, b, wk, p0, s, t, true);
  tile_G(net, w, wk, p0, s, t, true);
  tile_backward(net, wk, p0, s, t);
  for (int p = threadIdx.x; p < C::P && p < n_valid; p += C::THREADS)
    for (int a = 0; a < 3; ++a) dx[(p0 + p) * 3 + a] = t.dxs()[p * 3 + a];
}

// ------------------------------ K5 ------------------------------
// dW[r][c] += sum_p X[p][r] Y[p][c] over one or two factor pairs: an SDF
// layer's (d, r_hat) and (g_tot, u), or a colour or background layer's
// (cotangent, input) from K7 or K9; db[r] += sum_p X[p][r] of the last pair
// (g_tot, or the cotangent), unless db is null. Rows are WMAX floats apart;
// dW rows ldw.
//
// A split-K GEMM over the points. A block owns a 256 x 128 tile of dW (at
// the 512 width each x row is read by 4 blocks and each y row by 2, through
// L2) and a contiguous share of the points (blockIdx.y), and adds its
// partial sums into dW with one atomic pass at its end. K5 only reads, so
// the bytes in flight set its speed: slabs of 32 points stream through a
// four-stage cp.async ring of the f32 rows (16-byte copies along the rows,
// a warp copying 512 contiguous bytes of one row; 4-byte ones where a row
// is not 16-byte aligned), three slabs (144 KB) ahead of the products.
// bf16: each landed slab is rounded once to bf16 into a point-major
// staging tile, which 16 warps of 64 x 32 mma.sync m16n8k16 tiles read
// through ldmatrix.trans (both operands are point-major, the transpose of
// what mma wants), f32 accumulation; f32: each thread adds 8 x 8 FMA
// products straight from the ring (exact f32 products; the bf16 runs are
// the ones that train at the operating point). db is summed in the same
// pass by the blocks of the first column tile, from the f32 values as
// landed, by all their threads.

constexpr int R_TM = 256, R_TN = 128, R_THREADS = 512, R_PC = 32, R_STAGES = 4;
constexpr int R_STAGE = R_PC * (R_TM + R_TN);  // floats of one ring stage: x then y rows
constexpr int R_XST = R_TM + 8, R_YST = R_TN + 8;  // bf16 staging row strides
constexpr int R_XLD = R_PC * R_TM / 4 / R_THREADS, R_YLD = R_PC * R_TN / 4 / R_THREADS;

struct FactorPair {
  const float* x;
  const float* y;
};

__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src, int bytes, bool vec) {
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// columns c .. c + 3 of a factor row into dst: zero at and past lim, and
// zero for a point past the block's share (in false; row is then any row
// of the share, which is never read)
__device__ __forceinline__ void copy_cols(float* dst, const float* row, int c, int lim, bool vec,
                                          bool in) {
  if (vec) {
    const int m = in ? min(max(lim - c, 0), 4) : 0;
    cp_async_zfill(dst, row + (m ? c : 0), 4 * m, true);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = in && c + j < lim;
      cp_async_zfill(dst + j, row + (ok ? c + j : 0), ok ? 4 : 0, false);
    }
  }
}

// one slab of bf16 products: warp (wm, wn) adds its 64 x 32 part of the tile
__device__ __forceinline__ void slab_products(const bf16* X, const bf16* Y, float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp >> 2) * 64, n0 = (warp & 3) * 32;
  const int i = lane & 7, j = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < R_PC; kk += 16) {
    unsigned a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4_trans(a[mi], X + (kk + i + ((j >> 1) << 3)) * R_XST + m0 + 16 * mi + ((j & 1) << 3));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      unsigned b[4];
      ldmatrix_x4_trans(b, Y + (kk + i + ((j & 1) << 3)) * R_YST + n0 + 16 * nj + ((j >> 1) << 3));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// one slab of f32 products: thread (tr, tc) adds rows {4 tr, 128 + 4 tr} +
// 0..3 by columns {4 tc, 64 + 4 tc} + 0..3
__device__ __forceinline__ void slab_products(const float* X, const float* Y, float (&acc)[8][8]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 4
  for (int pp = 0; pp < R_PC; ++pp) {
    const float4 x0 = *reinterpret_cast<const float4*>(X + pp * R_TM + 4 * tr);
    const float4 x1 = *reinterpret_cast<const float4*>(X + pp * R_TM + 128 + 4 * tr);
    const float4 y0 = *reinterpret_cast<const float4*>(Y + pp * R_TN + 4 * tc);
    const float4 y1 = *reinterpret_cast<const float4*>(Y + pp * R_TN + 64 + 4 * tc);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] += xv[a] * yv[b];
  }
}

template <typename T> struct RedAcc;
template <> struct RedAcc<bf16> { float v[4][4][4]; };
template <> struct RedAcc<float> { float v[8][8]; };

__device__ __forceinline__ void add_tile(const float (&acc)[4][4][4], int r0, int c0, int n, int k,
                                         float* dW, int ldw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = r0 + (warp >> 2) * 64, n0 = c0 + (warp & 3) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + 16 * mi + (lane >> 2) + (e >> 1) * 8;
        const int c = n0 + 8 * ni + 2 * (lane & 3) + (e & 1);
        if (r < n && c < k) atomicAdd(dW + (long long)r * ldw + c, acc[mi][ni][e]);
      }
}

__device__ __forceinline__ void add_tile(const float (&acc)[8][8], int r0, int c0, int n, int k,
                                         float* dW, int ldw) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int r = r0 + (a >> 2) * 128 + 4 * tr + (a & 3);
      const int c = c0 + (b >> 2) * 64 + 4 * tc + (b & 3);
      if (r < n && c < k) atomicAdd(dW + (long long)r * ldw + c, acc[a][b]);
    }
}

template <typename T>
constexpr size_t reduce_smem() {
  return R_STAGES * R_STAGE * sizeof(float) +
         (sizeof(T) == 2 ? R_PC * (R_XST + R_YST) * sizeof(bf16) : 0);
}

// vec: bit 0, the x rows are 16-byte aligned; bit 1, the y rows
template <typename T, int PAIRS>
__global__ void __launch_bounds__(R_THREADS)
reduce_kernel(FactorPair f0, FactorPair f1, int n, int k, long long n_pts, long long per,
              int tiles_c, float* dW, int ldw, float* db, int vec) {
  extern __shared__ __align__(16) unsigned char red_smem[];
  float* ring = reinterpret_cast<float*>(red_smem);                 // R_STAGES x R_STAGE
  bf16* xs = reinterpret_cast<bf16*>(ring + R_STAGES * R_STAGE);    // bf16: R_PC x R_XST
  bf16* ys = xs + R_PC * R_XST;                                      //       R_PC x R_YST
  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / tiles_c) * R_TM, c0 = (blockIdx.x % tiles_c) * R_TN;
  const long long lo = blockIdx.y * per, hi = min(n_pts, lo + per);
  const int slabs = (int)((hi - lo + R_PC - 1) / R_PC), total = PAIRS * slabs;
  const bool with_db = db != nullptr && c0 == 0;
  const bool vx = vec & 1, vy = vec & 2;
  // thread tid copies (and rounds, and sums for db) columns 4 xc .. 4 xc + 3
  // of x at points xp + 8 i, and of y columns 4 yc .. at points yp + 16 i
  const int xc = tid & (R_TM / 4 - 1), xp = tid / (R_TM / 4);
  const int yc = tid & (R_TN / 4 - 1), yp = tid / (R_TN / 4);
  float4 dsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  RedAcc<T> acc = {};

  // slab s of the pairs in turn into ring stage s % R_STAGES
  auto issue = [&](int s) {
    if (s < total) {
      const bool second = PAIRS == 2 && s >= slabs;
      const FactorPair f = second ? f1 : f0;
      const long long q = lo + (long long)(second ? s - slabs : s) * R_PC;
      float* st = ring + (s % R_STAGES) * R_STAGE;
#pragma unroll
      for (int i = 0; i < R_XLD; ++i) {
        const int pp = xp + (R_THREADS / (R_TM / 4)) * i;
        const bool in = q + pp < hi;
        copy_cols(st + pp * R_TM + 4 * xc, f.x + (in ? q + pp : lo) * WMAX + r0, 4 * xc, n - r0,
                  vx, in);
      }
#pragma unroll
      for (int i = 0; i < R_YLD; ++i) {
        const int pp = yp + (R_THREADS / (R_TN / 4)) * i;
        const bool in = q + pp < hi;
        copy_cols(st + R_PC * R_TM + pp * R_TN + 4 * yc, f.y + (in ? q + pp : lo) * WMAX + c0,
                  4 * yc, k - c0, vy, in);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < R_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<R_STAGES - 2>();  // slab s has landed
    __syncthreads();  // for every thread; slab s - 1's stage and the staging tile are free
    issue(s + R_STAGES - 1);
    const float* X = ring + (s % R_STAGES) * R_STAGE;
    const float* Y = X + R_PC * R_TM;
    const bool sum_db = with_db && (PAIRS == 1 || s >= slabs);
#pragma unroll
    for (int i = 0; i < R_XLD; ++i) {
      const int pp = xp + (R_THREADS / (R_TM / 4)) * i;
      const float4 x = *reinterpret_cast<const float4*>(X + pp * R_TM + 4 * xc);
      if (sum_db) dsum.x += x.x, dsum.y += x.y, dsum.z += x.z, dsum.w += x.w;
      if constexpr (sizeof(T) == 2) {
        __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
        *reinterpret_cast<uint2*>(xs + pp * R_XST + 4 * xc) = *reinterpret_cast<uint2*>(h);
      }
    }
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < R_YLD; ++i) {
        const int pp = yp + (R_THREADS / (R_TN / 4)) * i;
        const float4 y = *reinterpret_cast<const float4*>(Y + pp * R_TN + 4 * yc);
        __nv_bfloat162 h[2] = {__floats2bfloat162_rn(y.x, y.y), __floats2bfloat162_rn(y.z, y.w)};
        *reinterpret_cast<uint2*>(ys + pp * R_YST + 4 * yc) = *reinterpret_cast<uint2*>(h);
      }
      __syncthreads();
      slab_products(xs, ys, acc.v);
    } else {
      slab_products(X, Y, acc.v);
    }
  }
  add_tile(acc.v, r0, c0, n, k, dW, ldw);
  if (with_db) {  // the block's column sums: the partial sums of each column's threads
    constexpr int GROUPS = R_THREADS / (R_TM / 4);
    __syncthreads();
    float* red = ring;
    *reinterpret_cast<float4*>(red + xp * R_TM + 4 * xc) = dsum;
    __syncthreads();
    if (tid < R_TM && r0 + tid < n) {
      float sum = 0.0f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) sum += red[g * R_TM + tid];
      atomicAdd(db + r0 + tid, sum);
    }
  }
}

}  // namespace

// Each entry returns a cudaError_t value (0 = launched) or -1 for shapes
// the kernels do not take. Per layer l (host arrays of n_layers entries):
// k, n its input and output widths; the packed weights hold W_l as
// (npad, kpad) at w_off and W_l^T as (kpad, npad) at wt_off, zero-padded,
// in float (bf16 == 0) or bf16; b holds the f32 biases at b_off. work is a
// float32 workspace of work_rows * 528 elements per slot: n_layers - 1
// slots for the forward (z per hidden layer), 6 kinds x n_layers for the
// backward; work_rows >= n_pts rounded up to 64.

extern "C" int nw_sdf_vjp_fwd(const float* pts, long long n_pts, const void* w, const float* b,
                              int bf16_act, int n_layers, int multires, float scale,
                              int skip_mask, const int* k, const int* n, const int* kpad,
                              const int* npad, const long long* w_off, const long long* wt_off,
                              const int* b_off, float* work, long long work_rows, float* out,
                              float* grad, void* stream) {
  Net net;
  if (make_net(n_layers, multires, scale, skip_mask, k, n, kpad, npad, w_off, wt_off, b_off,
               &net) || work_rows < ((n_pts + 63) / 64) * 64)
    return -1;
  SchedMaker sb;
  sb.F(net);
  sb.last(net);
  sb.G(net);
  if (!sb.ok) return -1;
  Work wk{work, work_rows, n_layers, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  const auto run = [&](auto kern, const auto* wt, int P, int threads, size_t smem) {
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + P - 1) / P), threads, smem, s>>>(pts, n_pts, wt, b, net, sb.s, wk,
                                                                out, grad);
    return (int)cudaGetLastError();
  };
  if (bf16_act)
    return run(sdf_vjp_fwd_kernel<bf16>, static_cast<const bf16*>(w), Cfg<bf16>::P,
               Cfg<bf16>::THREADS, tile_bytes<bf16>());
  return run(sdf_vjp_fwd_kernel<float>, static_cast<const float*>(w), Cfg<float>::P,
             Cfg<float>::THREADS, tile_bytes<float>());
}

extern "C" int nw_sdf_vjp_bwd(const float* pts, long long n_pts, const float* c_out,
                              const float* c_grad, const void* w, const float* b, int bf16_act,
                              int n_layers, int multires, float scale, int skip_mask,
                              const int* k, const int* n, const int* kpad, const int* npad,
                              const long long* w_off, const long long* wt_off, const int* b_off,
                              float* work, long long work_rows, float* dx, void* stream) {
  Net net;
  if (make_net(n_layers, multires, scale, skip_mask, k, n, kpad, npad, w_off, wt_off, b_off,
               &net) || work_rows < ((n_pts + 63) / 64) * 64)
    return -1;
  SchedMaker sb;
  sb.F(net);
  sb.G(net);
  sb.backward(net);
  if (!sb.ok) return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  const auto run = [&](auto kern, const auto* wt, int P, int threads, size_t smem) {
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + P - 1) / P), threads, smem, s>>>(pts, n_pts, c_out, c_grad, wt, b,
                                                                net, sb.s, wk, dx);
    return (int)cudaGetLastError();
  };
  if (bf16_act)
    return run(sdf_vjp_bwd_kernel<bf16>, static_cast<const bf16*>(w), Cfg<bf16>::P,
               Cfg<bf16>::THREADS, tile_bytes<bf16>());
  return run(sdf_vjp_bwd_kernel<float>, static_cast<const float*>(w), Cfg<float>::P,
             Cfg<float>::THREADS, tile_bytes<float>());
}

namespace {

int launch_reduce(const float* X0, const float* Y0, const float* X1, const float* Y1, int n,
                  int k, long long n_pts, int bf16_act, float* dW, int ldw, float* db,
                  void* stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  // one wave: one block (its ring fills most of shared memory) on each SM
  // that has one, each over at least four slabs of points
  const int tiles_c = (k + R_TN - 1) / R_TN, tiles = ((n + R_TM - 1) / R_TM) * tiles_c;
  long long splits = max(1, sms / tiles);
  splits = max(1LL, min(splits, (n_pts + 4 * R_PC - 1) / (4 * R_PC)));
  const long long per = ((n_pts + splits - 1) / splits + R_PC - 1) / R_PC * R_PC;
  splits = (n_pts + per - 1) / per;
  const auto aligned = [](const float* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = (aligned(X0) && (!X1 || aligned(X1))) | (aligned(Y0) && (!Y1 || aligned(Y1))) << 1;
  const FactorPair f0{X0, Y0}, f1{X1, Y1};
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto kern, size_t smem) {
    if (int err = prepare(kern, smem)) return err;
    kern<<<grid, R_THREADS, smem, s>>>(f0, f1, n, k, n_pts, per, tiles_c, dW, ldw, db, vec);
    return (int)cudaGetLastError();
  };
  const size_t sb = reduce_smem<bf16>(), sf = reduce_smem<float>();
  if (bf16_act) return X1 ? run(reduce_kernel<bf16, 2>, sb) : run(reduce_kernel<bf16, 1>, sb);
  return X1 ? run(reduce_kernel<float, 2>, sf) : run(reduce_kernel<float, 1>, sf);
}

}  // namespace

// Adds layer l's dW (n x k, row-major) and db (n) over the first n_pts rows
// of the backward workspace (K4's, or the SDF part of K7's).
extern "C" int nw_sdf_vjp_reduce(const float* work, long long work_rows, int n_layers, int layer,
                                 int n, int k, long long n_pts, int bf16_act, float* dW,
                                 float* db, void* stream) {
  if (layer < 0 || layer >= n_layers || n <= 0 || k <= 0 || n > WMAX || k > NMAX ||
      n_pts > work_rows)
    return -1;
  if (n_pts <= 0) return 0;
  const long long lw = work_rows * WMAX;
  const float* D = work + (long long)(KD * n_layers + layer) * lw;
  const float* R = work + (long long)(KR * n_layers + layer) * lw;
  const float* G = work + (long long)(KG * n_layers + layer) * lw;
  const float* U = work + (long long)(KU * n_layers + layer) * lw;
  return launch_reduce(D, R, G, U, n, k, n_pts, bf16_act, dW, k, db, stream);
}

// One factor pair: dW[r][c] (row stride ldw) += sum_p x_p[r] y_p[c] and,
// unless db is null, db[r] += sum_p x_p[r], over n_pts rows of WMAX floats
// from x and from y.
extern "C" int nw_dw_reduce(const float* x, const float* y, int n, int k, long long n_pts,
                            int bf16_act, float* dW, int ldw, float* db, void* stream) {
  if (n <= 0 || k <= 0 || n > WMAX || k > WMAX || ldw < k) return -1;
  if (n_pts <= 0) return 0;
  return launch_reduce(x, y, nullptr, nullptr, n, k, n_pts, bf16_act, dW, ldw, db, stream);
}
