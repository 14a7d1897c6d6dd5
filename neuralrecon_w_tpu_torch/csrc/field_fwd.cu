// K6: the fused field forward, per point (rgb, sdf, d sdf / d x), with no
// parameter gradient.
//
// Replaces the TPU kernel ops/pallas_field.py:fused_field_forward (its
// _kernel): the SDF forward keeping each layer's pre-activation, the reverse
// sweep for d sdf / d x with softplus' = sigmoid(100 z) through the skip
// split and the PE Jacobian, then the IDR colour head on
// [x, grad, relu-static-head(xyz_final(feature), PE_view(dirs), a)] and
// the sigmoid. Mesh vertex colouring (parallel/sweep.sharded_rgb_sweep)
// runs it. The plain version is ops/field_forward.field_forward_plain.
//
// What bounds it: at the 8 x 512 SDF with the 512 / 128 / 256-wide colour
// head a point costs ~9 MFLOP (SDF forward ~4.2, reverse sweep ~3.7, colour
// ~1.0) against 52 bytes of input and 28 of output, so arithmetic bounds
// it, ~9 us per million points at the bf16 tensor-core peak.
//
// The design, simple first: K3's tile pass (sdf_tile.cuh: the tile GEMMs,
// F and G, one block per 64 points in bf16 / 32 in float) runs unchanged on
// a lean workspace: the reverse sweep needs z per layer, so the workspace
// keeps that one kind per layer and two rows each for u and d, in turns,
// L + 3 rows per point where K3 keeps 4 L. Then, in the same block:
//  * the SDF's last layer into the block's own workspace rows,
//    [sdf * scale | feature], and from there straight into xyz_final's
//    tile GEMM (no second kernel, no output array for the feature);
//  * x, grad, PE_view(dirs) and a staged per tile into workspace rows;
//  * the colour layers as tile GEMMs with fused epilogues (bias, ReLU,
//    sigmoid), color_tile.cuh's pass, shared with K7. The static head's
//    first layer takes [xyz_final | PE_view | a], 587 wide, past the
//    workspace row: it runs as two products into one f32 sum, the second
//    over columns 512.. of the same packed weight.
// Every GEMM operand is rounded to the activation dtype as it is staged,
// every sum is f32 and biases are added in f32, as in the TPU kernel.
// wgmma / TMA and keeping the tile's activations in shared memory come
// later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "color_tile.cuh"

namespace {

// workspace slots of the colour head, free once the SDF's last layer has
// read its input
enum Slot { S_OUT = 0, S_LIN_IN, S_VIEW, S_XYZ, S_PART, S_A, S_B, N_COLOR_SLOTS };

struct RgbEpi {  // sigmoid, for the tile's real points
  const float* b; float* rgb; long long n_valid;
  __device__ void operator()(int p, int j, float acc) const {
    if (p < n_valid) rgb[(long long)p * 3 + j] = 1.0f / (1.0f + expf(-(acc + b[j])));
  }
};

template <typename T, int P, int THREADS>
__global__ void __launch_bounds__(THREADS)
field_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const float* __restrict__ app, long long n_pts, const T* __restrict__ w,
                 const float* __restrict__ b, Net net, const T* __restrict__ cw,
                 const float* __restrict__ cb, Color col, Work wk, float* __restrict__ rgb,
                 float* __restrict__ sdf, float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  Tile t;
  tile_smem<T, P>(smem, t);
  const long long p0 = (long long)blockIdx.x * P;
  const long long n_valid = n_pts - p0;
  tile_forward<T, P>(pts + p0 * 3, n_valid, net, w, b, wk, p0, t, nullptr);
  __syncthreads();

  // the SDF's last layer, every row: [sdf * scale | feature]
  const int L = net.L;
  float* O = wk.slot(S_OUT, p0);
  for (int j0 = 0; j0 < net.n[L - 1]; j0 += NMAX) {
    OutEpi e{b + net.b_off[L - 1], O, WMAX, j0, P};
    gemm(wk.at(KU, L - 1, p0), net.k[L - 1], w + net.w_off[L - 1] + (long long)j0 * net.kpad[L - 1],
         net.kpad[L - 1], min(NMAX, net.n[L - 1] - j0), t.gemm, e);
  }

  // sdf and grad out; x, grad -> lin0's input, [PE_view(dirs) | a] -> V
  float* I0 = wk.slot(S_LIN_IN, p0);
  float* V = wk.slot(S_VIEW, p0);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool ok = p < n_valid;
    const long long o = (long long)p * WMAX;
    float g[3], d[3];
    pe_jac_T(t.xs + p * 3, net.multires, t.gpe + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) {
      d[a] = ok ? dirs[(p0 + p) * 3 + a] : 0.0f;
      I0[o + a] = ok ? pts[(p0 + p) * 3 + a] : 0.0f;
      I0[o + 3 + a] = g[a];
      if (ok) grad[(p0 + p) * 3 + a] = g[a];
    }
    if (ok) sdf[p0 + p] = O[o] / net.scale;
    for (int c = 0; c < col.d_view; ++c) V[o + c] = pe_value(d, c);
    for (int c = 0; c < col.n_a; ++c)
      V[o + col.d_view + c] = ok ? app[(p0 + p) * col.n_a + c] : 0.0f;
  }
  __syncthreads();

  // the colour head: its layers' inputs in turns in S_A / S_B (the static
  // head's first in S_XYZ, lin0's in S_LIN_IN)
  const int S = col.n_static;
  ColorRows rows{O, V, wk.slot(S_PART, p0), {}};
  rows.in[1] = wk.slot(S_XYZ, p0);
  for (int i = 2; i < col.n_layers; ++i) {
    const int turn = i <= S ? i - 2 : i - 2 - S;
    rows.in[i] = i == 1 + S ? I0 : wk.slot((turn & 1) ? S_B : S_A, p0);
  }
  RgbEpi e{cb + col.b_off[col.n_layers - 1], rgb + p0 * 3, n_valid};
  color_forward<T>(cw, cb, col, rows, t.gemm, e);
}

}  // namespace

// Returns a cudaError_t value (0 = launched) or -1 for shapes the kernel
// does not take. The SDF arguments are nw_sdf_vjp_fwd's (sdf_vjp.cu). The
// colour net's layers (xyz_final, n_static static layers, then the main
// branch) are packed as (round_up(n, 16), kpad) row-major blocks at cw_off
// in the activation dtype, biases f32 at cb_off. app holds n_a floats per
// point. work is a float32 workspace of work_slots * work_rows * 528
// elements, work_slots >= max(n_layers + 3, 7), work_rows >= n_pts rounded
// up to 64.
extern "C" int nw_field_fwd(const float* pts, const float* dirs, const float* app,
                            long long n_pts, const void* w, const float* b, int bf16_act,
                            int n_layers, int multires, float scale, int skip_mask, const int* k,
                            const int* n, const int* kpad, const int* npad,
                            const long long* w_off, const long long* wt_off, const int* b_off,
                            const void* cw, const float* cb, int c_layers, int n_static,
                            int multires_view, int n_a, const int* ck, const int* cn,
                            const int* ckpad, const long long* cw_off, const int* cb_off,
                            float* work, long long work_rows, int work_slots, float* rgb,
                            float* sdf, float* grad, void* stream) {
  Net net;
  Color col;
  if (make_net(n_layers, multires, scale, skip_mask, k, n, kpad, npad, w_off, wt_off, b_off,
               &net) ||
      make_color(c_layers, n_static, multires_view, n_a, n[n_layers - 1] - 1, ck, cn, ckpad,
                 nullptr, cw_off, nullptr, cb_off, &col) ||
      work_rows < ((n_pts + 63) / 64) * 64 || work_slots < n_layers + 3 ||
      work_slots < N_COLOR_SLOTS)
    return -1;
  Work wk{work, work_rows, n_layers, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  if (bf16_act) {
    auto kern = field_fwd_kernel<bf16, M_P, M_THREADS>;
    const size_t smem = smem_bytes<bf16, M_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + M_P - 1) / M_P), M_THREADS, smem, s>>>(
        pts, dirs, app, n_pts, static_cast<const bf16*>(w), b, net,
        static_cast<const bf16*>(cw), cb, col, wk, rgb, sdf, grad);
  } else {
    auto kern = field_fwd_kernel<float, F_P, F_THREADS>;
    const size_t smem = smem_bytes<float, F_P>();
    if (int err = prepare(kern, smem)) return err;
    kern<<<(unsigned)((n_pts + F_P - 1) / F_P), F_THREADS, smem, s>>>(
        pts, dirs, app, n_pts, static_cast<const float*>(w), b, net,
        static_cast<const float*>(cw), cb, col, wk, rgb, sdf, grad);
  }
  return (int)cudaGetLastError();
}
