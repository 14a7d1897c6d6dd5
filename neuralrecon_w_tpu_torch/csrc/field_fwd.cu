// K6: the fused field forward, per point (rgb, sdf, d sdf / d x), with no
// parameter gradient.
//
// Replaces the TPU kernel ops/pallas_field.py:fused_field_forward (its
// _kernel): the SDF forward keeping each layer's pre-activation, the reverse
// sweep for d sdf / d x with softplus' = sigmoid(100 z) through the skip
// split and the PE Jacobian, then the IDR colour head on
// [x, grad, relu-static-head(xyz_final(feature), PE_view(dirs), a)] and
// the sigmoid. Mesh vertex colouring (parallel/sweep.sharded_rgb_sweep)
// runs it, and the forward of SDF_GRAD_MODE="pallas_field". The plain
// version is ops/field_forward.field_forward_plain.
//
// What bounds it, by the counts: at the 8 x 512 SDF with the 512 / 128 /
// 256-wide colour head a point costs ~9.1 MFLOP (SDF forward ~4.2, reverse
// sweep ~3.7, colour ~1.2) against 52 bytes of input and 28 of output, so
// the tensor cores bound it: 0.60 ms per 65,536 points at the bf16 peak.
// The only rows it writes are G's inputs, z per hidden layer: 8 x 2 KB a
// point, 1.1 GB at 65,536 points, written and read back once (~0.6 ms at
// 3.35 TB/s, most of it served by L2).
//
// The design: one block per tile of points runs the shared tile pass
// (sdf_tile.cuh) in the order F, the SDF's last layer, xyz_final and the
// static head (color_tile.cuh), G, lin0 ... rgb. The running operand stays
// in shared memory in the activation dtype, each layer's output written
// over its input; the weights of all ~25 products stream through one
// cp.async ring of k-slabs that runs ahead across products. The static
// head's output waits in a stash while G holds the operand; its first
// layer takes [xyz_final | PE_view | a] as one product over two shared
// operands. The workspace holds z per hidden layer and nothing else.
// Shared memory (bf16: 64 points, 8 warps) 228,896 bytes: the operand 64 x
// 536 bf16, a three-stage ring of swizzled 512 x 32 bf16 slabs, the GEMM
// list, the per-point PE vectors; float: 32 points, 8 warps, f32 FMA,
// 202,272.
// Registers and spills: see PERF.md (ptxas -v, printed by chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "color_tile.cuh"

namespace {

struct RgbEpi {  // sigmoid, for the tile's real points
  const float* b; float* rgb; long long n_valid;
  __device__ void operator()(int p, int j, float a0, float a1) const {
    if (p >= n_valid) return;
    if (j < 3) rgb[(long long)p * 3 + j] = 1.0f / (1.0f + expf(-(a0 + b[j])));
    if (j + 1 < 3) rgb[(long long)p * 3 + j + 1] = 1.0f / (1.0f + expf(-(a1 + b[j + 1])));
  }
};

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
field_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const float* __restrict__ app, long long n_pts, const T* __restrict__ w,
                 const float* __restrict__ b, Net net, const T* __restrict__ cw,
                 const float* __restrict__ cb, Color col, Sched sched, Work wk,
                 float* __restrict__ rgb, float* __restrict__ sdf, float* __restrict__ grad) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<T> t{smem};
  Stream<T> s = start_stream(sched, w, cw, t);
  const long long p0 = (long long)blockIdx.x * C::P;
  const long long n_valid = n_pts - p0;
  const ColorRows none{nullptr, 0, 0};
  tile_pe(pts + p0 * 3, n_valid, net, wk, p0, t, false);
  tile_F(net, b, wk, p0, s, t, false);
  sdf_out_layer(net, w, b, col, s, t, nullptr, sdf + p0, n_valid);
  color_static(col, cb, s, t, dirs + p0 * 3, app + p0 * col.n_a, n_valid, none);
  tile_G(net, w, wk, p0, s, t, false);
  auto e = [&] { return RgbEpi{cb + col.b_off[col.n_layers - 1], rgb + p0 * 3, n_valid}; };
  color_lin(net, col, cb, s, t, pts + p0 * 3, n_valid, none, grad + p0 * 3, e);
}

template <typename T>
int launch(const float* pts, const float* dirs, const float* app, long long n_pts, const void* w,
           const float* b, const Net& net, const void* cw, const float* cb, const Color& col,
           const Sched& sched, const Work& wk, float* rgb, float* sdf, float* grad,
           cudaStream_t s) {
  auto kern = field_fwd_kernel<T>;
  constexpr size_t smem = tile_bytes<T>();
  if (int err = prepare(kern, smem)) return err;
  kern<<<(unsigned)((n_pts + Cfg<T>::P - 1) / Cfg<T>::P), Cfg<T>::THREADS, smem, s>>>(
      pts, dirs, app, n_pts, static_cast<const T*>(w), b, net, static_cast<const T*>(cw), cb,
      col, sched, wk, rgb, sdf, grad);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 = launched) or -1 for shapes the kernel
// does not take. The SDF arguments are nw_sdf_vjp_fwd's (sdf_vjp.cu). The
// colour net's layers (xyz_final, n_static static layers, then the main
// branch) are packed as (round_up(n, 16), kpad) row-major blocks at cw_off
// in the activation dtype, biases f32 at cb_off. app holds n_a floats per
// point. work is a float32 workspace of work_slots * work_rows * 528
// elements, work_slots >= n_layers - 1 (z per hidden layer), work_rows >=
// n_pts rounded up to 64.
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
      !(bf16_act ? color_fits<bf16>(col) : color_fits<float>(col)) ||
      work_rows < ((n_pts + 63) / 64) * 64 || work_slots < n_layers - 1)
    return -1;
  SchedMaker sb;
  sb.F(net);
  sb.last(net);
  color_fwd_sched(sb, col, 0, n_static + 1);
  sb.G(net);
  color_fwd_sched(sb, col, n_static + 1, c_layers);
  if (!sb.ok) return -1;
  Work wk{work, work_rows, n_layers, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  return bf16_act ? launch<bf16>(pts, dirs, app, n_pts, w, b, net, cw, cb, col, sb.s, wk, rgb, sdf,
                                 grad, s)
                  : launch<float>(pts, dirs, app, n_pts, w, b, net, cw, cb, col, sb.s, wk, rgb,
                                  sdf, grad, s);
}
