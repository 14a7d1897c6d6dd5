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
// What bounds it: at the 8 x 512 width a point costs ~4 MFLOP forward and
// ~16 MFLOP backward, so arithmetic bounds it. Per point the residuals are
// 9 layers x 512 wide, and the backward needs six such families (u, z, d,
// a, r_hat, g_tot); at 64 points a tile that is ~9 MB, far beyond 227 KB
// of shared memory.
//
// The design, simple first:
//  * One block per tile of points (bf16: 64 points, 16 warps, mma.sync
//    m16n8k16 with f32 accumulation; float: 32 points, 8 warps, FMA). The
//    block runs every layer of its tile in turn as a tile GEMM
//    out[p][j] = sum_i A[p][i] M[j][i] with its epilogue fused; A comes
//    from the block's own rows of a float32 workspace in device memory
//    (the per-layer residuals), M is a packed weight (W for the forward
//    products, a packed transpose W^T for the reverse ones), both staged
//    through shared memory in k-slabs. GEMM operands are rounded to the
//    activation dtype as they are staged; everything else stays f32.
//  * K3 (nw_sdf_vjp_fwd): F and G per tile -> out (N, d_out), grad (N, 3).
//  * K4 (nw_sdf_vjp_bwd): recomputes F and G, runs the adjoint of G and the
//    backward of F, writes dx and leaves per layer the dW factor pairs
//    (d_l, r_hat_l) and (g_tot_l, u_l) in the workspace.
//  * K5 (nw_sdf_vjp_reduce): dW_l = d_l^T r_hat_l + g_tot_l^T u_l and
//    db_l = sum g_tot_l over the points, a split-K reduction (mma.sync in
//    bf16, FMA in float) with f32 atomics into dW.
// The TPU kernel's split of the layer set over two calls (VMEM could not
// hold the weights and all dW accumulators) has no counterpart: dW is
// reduced outside the per-tile kernel. The wrapper runs K3 and K4 + K5 over
// point chunks so the workspace stays a few GB.
// The tile GEMMs, F and G and K4's per-tile backward (tile_backward) live in
// sdf_tile.cuh, shared with K6 and K7; K7 and K9 reduce their dW factor
// pairs through K5 (nw_dw_reduce, one pair per call).
// wgmma / TMA, and keeping the residuals in shared memory, come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf_tile.cuh"

namespace {

// K3
template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
sdf_vjp_fwd_kernel(const float* __restrict__ pts, long long n_pts, const T* __restrict__ w,
                   const float* __restrict__ b, Net net, Work wk, float* __restrict__ out,
                   float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  Tile t;
  tile_smem<T, P>(smem, t);
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  tile_forward<T, P>(pts + p0 * 3, n_valid, net, w, b, wk, p0, t,
                     out + p0 * net.n[net.L - 1]);
  __syncthreads();
  for (int p = threadIdx.x; p < P && p < n_valid; p += blockDim.x) {
    float g[3];
    pe_jac_T(t.xs + p * 3, net.multires, t.gpe + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) grad[(p0 + p) * 3 + a] = g[a];
  }
}

// K4
template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
sdf_vjp_bwd_kernel(const float* __restrict__ pts, long long n_pts, const float* __restrict__ c_out,
                   const float* __restrict__ c_grad, const T* __restrict__ w,
                   const float* __restrict__ b, Net net, Work wk, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  Tile t;
  tile_smem<T, P>(smem, t);
  const int L = net.L, n_last = net.n[L - 1];
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  tile_forward<T, P>(pts + p0 * 3, n_valid, net, w, b, wk, p0, t, nullptr);
  __syncthreads();
  // the cotangents into the tile: g_tot_{L-1} = c_out, c_grad
  float* GL = wk.at(KG, L - 1, p0);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    for (int a = 0; a < 3; ++a) t.cg[p * 3 + a] = p < n_valid ? c_grad[(p0 + p) * 3 + a] : 0.0f;
    for (int j = 0; j < n_last; ++j)
      GL[(long long)p * WMAX + j] = p < n_valid ? c_out[(p0 + p) * n_last + j] : 0.0f;
  }
  __syncthreads();
  tile_backward<T, P>(net, w, wk, p0, t);
  for (int p = threadIdx.x; p < P && p < n_valid; p += blockDim.x)
    for (int a = 0; a < 3; ++a) dx[(p0 + p) * 3 + a] = t.dxs[p * 3 + a];
}

// ------------------------------ K5 ------------------------------
// dW[r][c] += sum_p X[p][r] Y[p][c] over one or two factor pairs, for the
// block's 64 x 64 tile and point range: an SDF layer's (d, r_hat) and
// (g_tot, u), or a colour or background layer's (cotangent, input) from K7
// or K9; db[r] += sum_p X[p][r] of the last pair (g_tot, or the cotangent)
// in the blocks of the first column tile, unless db is null. Rows are WMAX
// floats apart; dW rows ldw.

constexpr int R_T = 64;

__device__ void colsum_db(const float* G, int n, long long lo, long long hi, float* db) {
  const int r = blockIdx.x * R_T + threadIdx.x;
  if (!db || blockIdx.y != 0 || threadIdx.x >= R_T || r >= n) return;
  float s = 0.0f;
  for (long long p = lo; p < hi; ++p) s += G[p * WMAX + r];
  atomicAdd(db + r, s);
}

constexpr int RF_THREADS = 256, RF_PC = 16;

template <int PAIRS>
__global__ void __launch_bounds__(RF_THREADS)
reduce_f32_kernel(const float* X0, const float* Y0, const float* X1, const float* Y1, int n,
                  int k, long long n_rows, long long per, float* dW, int ldw, float* db) {
  __shared__ __align__(16) float Xs[RF_PC][R_T];
  __shared__ __align__(16) float Ys[RF_PC][R_T];
  const int tid = threadIdx.x, tn = tid >> 4, tk = tid & 15;
  const int r0 = blockIdx.x * R_T, c0 = blockIdx.y * R_T;
  const long long lo = blockIdx.z * per, hi = min(n_rows, lo + per);
  float acc[4][4] = {};
  for (int pair = 0; pair < PAIRS; ++pair) {
    const float* X = pair ? X1 : X0;
    const float* Y = pair ? Y1 : Y0;
    for (long long q = lo; q < hi; q += RF_PC) {
      __syncthreads();
      for (int e = tid; e < RF_PC * R_T; e += RF_THREADS) {
        const int pp = e / R_T, i = e - pp * R_T;
        const bool in = q + pp < hi;
        Xs[pp][i] = in && r0 + i < n ? X[(q + pp) * WMAX + r0 + i] : 0.0f;
        Ys[pp][i] = in && c0 + i < k ? Y[(q + pp) * WMAX + c0 + i] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int pp = 0; pp < RF_PC; ++pp) {
        const float4 x = *reinterpret_cast<const float4*>(&Xs[pp][4 * tn]);
        const float4 y = *reinterpret_cast<const float4*>(&Ys[pp][4 * tk]);
        const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * yv[j];
      }
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 4 * tn + i, c = c0 + 4 * tk + j;
      if (r < n && c < k) atomicAdd(dW + (long long)r * ldw + c, acc[i][j]);
    }
  colsum_db(PAIRS == 2 ? X1 : X0, n, lo, hi, db);
}

constexpr int RB_THREADS = 128, RB_PC = 32, RB_ST = RB_PC + 8;

template <int PAIRS>
__global__ void __launch_bounds__(RB_THREADS)
reduce_bf16_kernel(const float* X0, const float* Y0, const float* X1, const float* Y1, int n,
                   int k, long long n_rows, long long per, float* dW, int ldw, float* db) {
  // transposed staging: row = output index, the points contiguous, so the
  // fragments load as in the tile GEMM (A = X^T row-major, B = Y^T as N x K)
  __shared__ __align__(16) bf16 Xs[R_T * RB_ST];
  __shared__ __align__(16) bf16 Ys[R_T * RB_ST];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 32;
  const int r0 = blockIdx.x * R_T, c0 = blockIdx.y * R_T;
  const long long lo = blockIdx.z * per, hi = min(n_rows, lo + per);
  float acc[2][4][4] = {};
  for (int pair = 0; pair < PAIRS; ++pair) {
    const float* X = pair ? X1 : X0;
    const float* Y = pair ? Y1 : Y0;
    for (long long q = lo; q < hi; q += RB_PC) {
      __syncthreads();
      for (int e = tid; e < RB_PC * R_T; e += RB_THREADS) {
        const int pp = e / R_T, i = e - pp * R_T;
        const bool in = q + pp < hi;
        Xs[i * RB_ST + pp] = __float2bfloat16(in && r0 + i < n ? X[(q + pp) * WMAX + r0 + i] : 0.0f);
        Ys[i * RB_ST + pp] = __float2bfloat16(in && c0 + i < k ? Y[(q + pp) * WMAX + c0 + i] : 0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < RB_PC; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], Xs + (row0 + 16 * mi + (lane & 15)) * RB_ST + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned bb[4];
          ldmatrix_x4(bb, Ys + (col0 + 16 * nj + (lane & 7) + ((lane >> 4) << 3)) * RB_ST + kk +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], a[mi], bb[0], bb[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], bb[2], bb[3]);
          }
        }
      }
    }
  }
  for (int mi = 0; mi < 2; ++mi)
    for (int ni = 0; ni < 4; ++ni)
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + row0 + 16 * mi + (lane >> 2) + (e >> 1) * 8;
        const int c = c0 + col0 + 8 * ni + 2 * (lane & 3) + (e & 1);
        if (r < n && c < k) atomicAdd(dW + (long long)r * ldw + c, acc[mi][ni][e]);
      }
  colsum_db(PAIRS == 2 ? X1 : X0, n, lo, hi, db);
}

}  // namespace

// Each entry returns a cudaError_t value (0 = launched) or -1 for shapes
// the kernels do not take. Per layer l (host arrays of n_layers entries):
// k, n its input and output widths; the packed weights hold W_l as
// (npad, kpad) at w_off and W_l^T as (kpad, npad) at wt_off, zero-padded,
// in float (bf16 == 0) or bf16; b holds the f32 biases at b_off. work is a
// float32 workspace of (kinds * n_layers * work_rows * 528) elements, with
// 4 kinds for the forward and 6 for the backward; work_rows >= n_pts
// rounded up to 64.

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
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = sdf_vjp_fwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = smem_bytes<bf16, M_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        pts, n_pts, static_cast<const bf16*>(w), b, net, wk, out, grad);
  } else {
    auto kern = sdf_vjp_fwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = smem_bytes<float, F_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        pts, n_pts, static_cast<const float*>(w), b, net, wk, out, grad);
  }
  return (int)cudaGetLastError();
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
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = sdf_vjp_bwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = smem_bytes<bf16, M_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        pts, n_pts, c_out, c_grad, static_cast<const bf16*>(w), b, net, wk, dx);
  } else {
    auto kern = sdf_vjp_bwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = smem_bytes<float, F_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        pts, n_pts, c_out, c_grad, static_cast<const float*>(w), b, net, wk, dx);
  }
  return (int)cudaGetLastError();
}

namespace {

int launch_reduce(const float* X0, const float* Y0, const float* X1, const float* Y1, int n,
                  int k, long long n_pts, int bf16_act, float* dW, int ldw, float* db,
                  void* stream) {
  const unsigned gx = (n + R_T - 1) / R_T, gy = (k + R_T - 1) / R_T;
  long long splits = (1024 + gx * gy - 1) / (gx * gy);
  splits = splits < 1 ? 1 : splits;
  splits = splits > (n_pts + 255) / 256 ? (n_pts + 255) / 256 : splits;
  const long long per = (n_pts + splits - 1) / splits;
  dim3 grid(gx, gy, (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_act && X1)
    reduce_bf16_kernel<2><<<grid, RB_THREADS, 0, s>>>(X0, Y0, X1, Y1, n, k, n_pts, per, dW, ldw, db);
  else if (bf16_act)
    reduce_bf16_kernel<1><<<grid, RB_THREADS, 0, s>>>(X0, Y0, X1, Y1, n, k, n_pts, per, dW, ldw, db);
  else if (X1)
    reduce_f32_kernel<2><<<grid, RF_THREADS, 0, s>>>(X0, Y0, X1, Y1, n, k, n_pts, per, dW, ldw, db);
  else
    reduce_f32_kernel<1><<<grid, RF_THREADS, 0, s>>>(X0, Y0, X1, Y1, n, k, n_pts, per, dW, ldw, db);
  return (int)cudaGetLastError();
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
