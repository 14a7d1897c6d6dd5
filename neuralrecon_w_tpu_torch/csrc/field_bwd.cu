// K7: the backward of the fused field (SDF + colour head): per point the
// cotangents (c_rgb, c_sdf, c_grad) of (rgb, sdf, grad) give dx, d_dirs,
// d_a and, per layer, the dW factor pairs that K5 reduces.
//
// Replaces the TPU kernel ops/pallas_field_train.py:field_bwd_pallas (its
// _ftrain_bwd_kernel), the backward of SDF_GRAD_MODE="pallas_field"; the
// forward of that mode is K6 (field_fwd.cu), which computes the same
// (rgb, sdf, grad). The plain version is
// ops/field_train.field_train_bwd_plain.
//
// What bounds it: at the 8 x 512 SDF with the 512 / 128 / 256-wide colour
// head a point costs ~21 MFLOP (the SDF forward and reverse sweep ~7.9, its
// second-order backward ~11.5, the colour forward and backward ~2.2), so
// arithmetic bounds it. Per point the residuals are 6 kinds x 9 SDF layers
// plus two rows per colour layer, 528 floats each (~143 KB); far beyond
// 227 KB of shared memory for a tile of 64.
//
// The design, simple first, per tile of points (bf16: 64 points, 16 warps,
// mma.sync; float: 32 points, 8 warps, FMA), every product a tile GEMM
// over the block's own rows of a float32 workspace (sdf_tile.cuh):
//  * K4's forward pass (tile_forward: F and G, every kind per layer);
//  * the SDF's last layer into a row [sdf * scale | feature], then K6's
//    colour pass (color_tile.cuh) with each layer's input kept in a row of
//    its own, the last layer's epilogue turning c_rgb into the cotangent on
//    its z (sigmoid');
//  * the colour backward as tile GEMMs over the packed W^T, the ReLU masks
//    read off the kept inputs: lin_L .. lin0 (whose input cotangent splits
//    into d_pts, d_grad and the static head's), the static head, then its
//    first layer's 587-wide input cotangent in two products, split into
//    xyz_final's, d_PE_view (-> d_dirs through the view PE's Jacobian) and
//    d_a; xyz_final's W^T gives d_feature;
//  * the injection: the SDF output's cotangent [c_sdf / scale | d_feature]
//    and c_grad + d_grad, then K4's per-tile backward (tile_backward):
//    dx = its x-cotangent + d_pts.
// The TPU kernel emits dW from the kernel, split over n_groups calls
// because VMEM could not hold every accumulator; here the per-layer factor
// pairs stay in the workspace, (d, r_hat) and (g_tot, u) per SDF layer as
// K4 leaves them and (cotangent, input) per colour layer, and K5 reduces
// them (nw_sdf_vjp_reduce, nw_dw_reduce). wgmma / TMA and keeping the
// residuals in shared memory come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "color_tile.cuh"

namespace {

struct SigmoidGradEpi {  // the cotangent on the last layer's z: c_rgb s (1 - s)
  const float* b; const float* cot; float* G; long long n_valid;
  __device__ void operator()(int p, int j, float acc) const {
    const float s = 1.0f / (1.0f + expf(-(acc + b[j])));
    G[(long long)p * WMAX + j] = p < n_valid ? cot[(long long)p * 7 + j] * s * (1.0f - s) : 0.0f;
  }
};

struct MaskEpi {  // through a ReLU: r where the layer's output H is positive
  float* G; const float* H;
  __device__ void operator()(int p, int j, float r) const {
    const long long o = (long long)p * WMAX + j;
    G[o] = r * (H[o] > 0.0f ? 1.0f : 0.0f);
  }
};

struct Lin0BackEpi {  // r on lin0's input [x, grad, h]: d_pts, d_grad, h's cotangent
  float* dpts; float* cg; float* G; const float* H;
  __device__ void operator()(int p, int j, float r) const {
    if (j < 3) {
      dpts[p * 3 + j] = r;
    } else if (j < 6) {
      cg[p * 3 + j - 3] += r;
    } else {
      const long long o = (long long)p * WMAX;
      G[o + j - 6] = r * (H[o + j] > 0.0f ? 1.0f : 0.0f);
    }
  }
};

struct Static0BackEpi {  // r on [xyz_final | PE_view | a], columns j0 + j
  float* Gx; float* dpev; float* da; int n0, d_view, n_a, j0; long long n_valid;
  __device__ void operator()(int p, int j, float r) const {
    j += j0;
    if (j < n0) Gx[(long long)p * WMAX + j] = r;
    else if (j < n0 + d_view) dpev[p * PE_MAX + j - n0] = r;
    else if (p < n_valid) da[(long long)p * n_a + j - n0 - d_view] = r;
  }
};

struct FeatEpi {  // d_feature into the SDF output's cotangent, columns 1..
  float* GL;
  __device__ void operator()(int p, int j, float r) const { GL[(long long)p * WMAX + 1 + j] = r; }
};

// slots past the SDF's 6 L: the SDF output row, [PE_view | a], colour layer
// i's input (i >= 1), colour layer i's cotangent
__host__ __device__ inline int color_slots(int n_color) { return 2 * n_color + 1; }

template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
field_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const float* __restrict__ app, const float* __restrict__ cot, long long n_pts,
                 const T* __restrict__ w, const float* __restrict__ b, Net net,
                 const T* __restrict__ cw, const float* __restrict__ cb, Color col, Work wk,
                 float* __restrict__ dx, float* __restrict__ d_dirs, float* __restrict__ d_a) {
  extern __shared__ __align__(16) float smem[];
  Tile t;
  tile_smem<T, P>(smem, t);
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  tile_forward<T, P>(pts + p0 * 3, n_valid, net, w, b, wk, p0, t, nullptr);
  __syncthreads();

  const int L = net.L, C = col.n_layers, S = col.n_static, base = 6 * L;
  auto in = [&](int i) { return wk.slot(base + 1 + i, p0); };
  auto G = [&](int i) { return wk.slot(base + C + 1 + i, p0); };
  float* O = wk.slot(base, p0);
  float* V = wk.slot(base + 1, p0);

  // the SDF's last layer, every row: [sdf * scale | feature]
  for (int j0 = 0; j0 < net.n[L - 1]; j0 += NMAX) {
    OutEpi e{b + net.b_off[L - 1], O, WMAX, j0, P};
    gemm(wk.at(KU, L - 1, p0), net.k[L - 1], w + net.w_off[L - 1] + (long long)j0 * net.kpad[L - 1],
         net.kpad[L - 1], min(NMAX, net.n[L - 1] - j0), t.gemm, e);
  }

  // x, grad -> lin0's input, [PE_view(dirs) | a] -> V; the cotangents:
  // c_sdf / scale into column 0 of the SDF output's, c_grad into t.cg
  float* I0 = in(1 + S);
  float* GL = wk.at(KG, L - 1, p0);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool ok = p < n_valid;
    const long long o = (long long)p * WMAX;
    float g[3], d[3];
    pe_jac_T(t.xs + p * 3, net.multires, t.gpe + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) {
      d[a] = ok ? dirs[(p0 + p) * 3 + a] : 0.0f;
      I0[o + a] = ok ? pts[(p0 + p) * 3 + a] : 0.0f;
      I0[o + 3 + a] = g[a];
      t.cg[p * 3 + a] = ok ? cot[(p0 + p) * 7 + 4 + a] : 0.0f;
    }
    GL[o] = ok ? cot[(p0 + p) * 7 + 3] / net.scale : 0.0f;
    for (int c = 0; c < col.d_view; ++c) V[o + c] = pe_value(d, c);
    for (int c = 0; c < col.n_a; ++c)
      V[o + col.d_view + c] = ok ? app[(p0 + p) * col.n_a + c] : 0.0f;
  }
  __syncthreads();

  // the colour head forward, each layer's input in its own row (the static
  // head's first product in layer 1's cotangent row, free until the
  // backward); the last layer's epilogue gives its cotangent
  ColorRows rows{O, V, G(1), {}};
  for (int i = 1; i < C; ++i) rows.in[i] = in(i);
  SigmoidGradEpi last{cb + col.b_off[C - 1], cot + p0 * 7, G(C - 1), n_valid};
  color_forward<T>(cw, cb, col, rows, t.gemm, last);

  // the colour head backward, r = g W per layer
  for (int i = C - 1; i > 1 + S; --i) {
    MaskEpi e{G(i - 1), in(i)};
    gemm(G(i), col.n[i], cw + col.wt_off[i], col.npad[i], col.k[i], t.gemm, e);
  }
  {
    Lin0BackEpi e{t.aux, t.cg, G(S), I0};
    gemm(G(1 + S), col.n[1 + S], cw + col.wt_off[1 + S], col.npad[1 + S], col.k[1 + S], t.gemm,
         e);
  }
  for (int i = S; i >= 2; --i) {
    MaskEpi e{G(i - 1), in(i)};
    gemm(G(i), col.n[i], cw + col.wt_off[i], col.npad[i], col.k[i], t.gemm, e);
  }
  for (int j0 = 0; j0 < col.k[1]; j0 += NMAX) {
    Static0BackEpi e{G(0), t.ghat, d_a + p0 * col.n_a, col.n[0], col.d_view, col.n_a, j0,
                     n_valid};
    gemm(G(1), col.n[1], cw + col.wt_off[1] + (long long)j0 * col.npad[1], col.npad[1],
         min(NMAX, col.k[1] - j0), t.gemm, e);
  }
  // d_dirs through the view PE's Jacobian
  for (int p = threadIdx.x; p < P && p < n_valid; p += blockDim.x) {
    float d[3], g[3];
    for (int a = 0; a < 3; ++a) d[a] = dirs[(p0 + p) * 3 + a];
    pe_jac_T(d, col.multires_view, t.ghat + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) d_dirs[(p0 + p) * 3 + a] = g[a];
  }
  {
    FeatEpi e{GL};
    gemm(G(0), col.n[0], cw + col.wt_off[0], col.npad[0], col.k[0], t.gemm, e);
  }

  // the SDF's second-order backward with the colour cotangents injected
  tile_backward<T, P>(net, w, wk, p0, t);
  for (int p = threadIdx.x; p < P && p < n_valid; p += blockDim.x)
    for (int a = 0; a < 3; ++a) dx[(p0 + p) * 3 + a] = t.dxs[p * 3 + a] + t.aux[p * 3 + a];
}

}  // namespace

// Returns a cudaError_t value (0 = launched) or -1 for shapes the kernel
// does not take. The SDF arguments are nw_sdf_vjp_bwd's (sdf_vjp.cu), the
// colour net's nw_field_fwd's (field_fwd.cu) with, per layer, npad and the
// packed W^T (kpad, npad) at cwt_off. cot holds per point [c_rgb (3), c_sdf,
// c_grad (3)]. work is a float32 workspace of work_slots * work_rows * 528
// elements, work_slots >= 6 n_layers + 2 c_layers + 1, work_rows >= n_pts
// rounded up to 64; on return it holds the dW factor pairs: the SDF layers'
// as K4 leaves them, then colour layer i's input in slot 6 n_layers + 1 + i
// (i >= 1; xyz_final's is columns 1.. of slot 6 n_layers, the static head's
// PE_view and a of slot 6 n_layers + 1) and its cotangent in slot
// 6 n_layers + c_layers + 1 + i.
extern "C" int nw_field_bwd(const float* pts, const float* dirs, const float* app,
                            const float* cot, long long n_pts, const void* w, const float* b,
                            int bf16_act, int n_layers, int multires, float scale, int skip_mask,
                            const int* k, const int* n, const int* kpad, const int* npad,
                            const long long* w_off, const long long* wt_off, const int* b_off,
                            const void* cw, const float* cb, int c_layers, int n_static,
                            int multires_view, int n_a, const int* ck, const int* cn,
                            const int* ckpad, const int* cnpad, const long long* cw_off,
                            const long long* cwt_off, const int* cb_off, float* work,
                            long long work_rows, int work_slots, float* dx, float* d_dirs,
                            float* d_a, void* stream) {
  Net net;
  Color col;
  if (make_net(n_layers, multires, scale, skip_mask, k, n, kpad, npad, w_off, wt_off, b_off,
               &net) ||
      make_color(c_layers, n_static, multires_view, n_a, n[n_layers - 1] - 1, ck, cn, ckpad,
                 cnpad, cw_off, cwt_off, cb_off, &col) ||
      work_rows < ((n_pts + 63) / 64) * 64 ||
      work_slots < 6 * n_layers + color_slots(c_layers))
    return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = field_bwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = smem_bytes<bf16, M_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        pts, dirs, app, cot, n_pts, static_cast<const bf16*>(w), b, net,
        static_cast<const bf16*>(cw), cb, col, wk, dx, d_dirs, d_a);
  } else {
    auto kern = field_bwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = smem_bytes<float, F_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        pts, dirs, app, cot, n_pts, static_cast<const float*>(w), b, net,
        static_cast<const float*>(cw), cb, col, wk, dx, d_dirs, d_a);
  }
  return (int)cudaGetLastError();
}
