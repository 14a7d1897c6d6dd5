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
// What bounds it, by the counts: at the 8 x 512 SDF with the 512 / 128 /
// 256-wide colour head a point costs ~20.9 MFLOP (the SDF forward and
// reverse sweep ~7.9, its second-order backward ~11.5, the colour forward
// and backward ~2.4): 4.5 ms per 245,760 points at the bf16 tensor-core
// peak. K5 reads the factor rows it leaves, so it must write them: 6 kinds
// x 9 SDF layers plus 15 colour rows, ~560 used floats each, ~150 KB a
// point, 37 GB per 245,760 points, ~11 ms at 3.35 TB/s. So the rows it must
// write bound it, then the products.
//
// The design: one block per tile of points runs the shared tile pass
// (sdf_tile.cuh, color_tile.cuh) with the running operand in shared memory
// in the activation dtype and every product's weights streaming through
// one cp.async ring that runs ahead across products:
//  * F writing u and z per layer; the SDF's last layer into the feature
//    (and the row [sdf * scale | feature]); xyz_final and the static head;
//    G writing a and d per layer; lin0 .. rgb, whose epilogue turns c_rgb
//    into the cotangent on its z (sigmoid');
//  * the colour backward over the packed W^T, each cotangent over the last
//    in shared memory, the ReLU masks read off the kept inputs: lin_L ..
//    lin0 (whose input cotangent splits into d_pts, d_grad and the static
//    head's), the static head, then its first layer's 587-wide input
//    cotangent in two products (the one past NMAX first: the other writes
//    over the operand), split into xyz_final's, d_PE_view (-> d_dirs
//    through the view PE's Jacobian) and d_a; xyz_final's W^T gives
//    d_feature;
//  * the injection: the SDF output's cotangent [c_sdf / scale | d_feature]
//    and c_grad + d_grad, then K4's per-tile backward (tile_backward):
//    dx = its x-cotangent + d_pts.
// Every row is written as paired stores from the fragment layout: (d,
// r_hat) and (g_tot, u) per SDF layer and (cotangent, input) per colour
// layer for K5, z, a and z2 for the later passes. The TPU kernel emitted
// dW itself, split over n_groups calls because VMEM could not hold every
// accumulator; here K5 reduces the factor pairs (nw_sdf_vjp_reduce,
// nw_dw_reduce). Shared memory: as K6 (field_fwd.cu), 228,896 bytes in
// bf16 (64 points, 8 warps), 202,272 in float (32 points, 8 warps, f32
// FMA). Registers and spills: PERF.md (ptxas -v).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "color_tile.cuh"

namespace {

template <typename T>
struct SigmoidGradEpi {  // the cotangent on the last layer's z: c_rgb s (1 - s)
  Tile<T> t; const float* b; const float* cot; float* G; int n_valid;
  __device__ float one(int p, int j, float acc) const {
    if (j >= 3 || p >= n_valid) return 0.0f;
    const float s = 1.0f / (1.0f + expf(-(acc + b[j])));
    return cot[(long long)p * 7 + j] * s * (1.0f - s);
  }
  __device__ void operator()(int p, int j, float a0, float a1) const {
    const float g0 = one(p, j, a0), g1 = one(p, j + 1, a1);
    st2(G + (long long)p * WMAX, j, 3, g0, g1);
    at2(t.act() + p * Cfg<T>::AST, j, 3, g0, g1);
  }
};

template <typename T>
struct MaskEpi {  // through a ReLU: r where the layer's output H is positive -> G, operand
  Tile<T> t; float* G; const float* H; int n;
  __device__ void operator()(int p, int j, float r0, float r1) const {
    if (j >= n) return;
    const long long o = (long long)p * WMAX;
    const float2 h = j + 1 < n ? ld2(H + o, j) : make_float2(H[o + j], 0.0f);
    const float g0 = h.x > 0.0f ? r0 : 0.0f, g1 = h.y > 0.0f ? r1 : 0.0f;
    st2(G + o, j, n, g0, g1);
    at2(t.act() + p * Cfg<T>::AST, j, n, g0, g1);
  }
};

template <typename T>
struct Lin0BackEpi {  // r on lin0's input [x, grad, h]: d_pts, d_grad, h's cotangent
  Tile<T> t; float* G; const float* H; int n;  // n: 6 + h's width
  __device__ void one(int p, int j, float r) const {
    if (j < 3) t.aux()[p * 3 + j] = r;
    else if (j < 6) t.cg()[p * 3 + j - 3] += r;
  }
  __device__ void operator()(int p, int j, float r0, float r1) const {
    if (j < 6) {
      one(p, j, r0);
      one(p, j + 1, r1);
      return;
    }
    if (j >= n) return;
    const long long o = (long long)p * WMAX;
    const float2 h = j + 1 < n ? ld2(H + o, j) : make_float2(H[o + j], 0.0f);
    const float g0 = h.x > 0.0f ? r0 : 0.0f, g1 = h.y > 0.0f ? r1 : 0.0f;
    st2(G + o, j - 6, n - 6, g0, g1);
    at2(t.act() + p * Cfg<T>::AST, j - 6, n - 6, g0, g1);
  }
};

template <typename T>
struct Static0BackEpi {  // r on [xyz_final | PE_view | a], columns j0 + j
  Tile<T> t; float* Gx; float* da; int n0, d_view, n_a, j0, n_valid;
  __device__ void one(int p, int j, float r) const {
    if (j < n0 + d_view) t.ghat()[p * PE_MAX + j - n0] = r;
    else if (j < n0 + d_view + n_a && p < n_valid) da[(long long)p * n_a + j - n0 - d_view] = r;
  }
  __device__ void operator()(int p, int j, float r0, float r1) const {
    j += j0;
    if (j < n0) {  // n0 is even: a pair lies on one side
      st2(Gx + (long long)p * WMAX, j, n0, r0, r1);
      at2(t.act() + p * Cfg<T>::AST, j, n0, r0, r1);
    } else {
      one(p, j, r0);
      one(p, j + 1, r1);
    }
  }
};

struct FeatEpi {  // d_feature into the SDF output's cotangent, columns 1..
  float* GL; int n;
  __device__ void operator()(int p, int j, float r0, float r1) const {
    st2(GL + (long long)p * WMAX + 1, j, n, r0, r1);
  }
};

// slots past the SDF's 6 L: the SDF output row, [PE_view | a], colour layer
// i's input (i >= 1), colour layer i's cotangent
__host__ __device__ inline int color_slots(int n_color) { return 2 * n_color + 1; }

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
field_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                 const float* __restrict__ app, const float* __restrict__ cot, long long n_pts,
                 const T* __restrict__ w, const float* __restrict__ b, Net net,
                 const T* __restrict__ cw, const float* __restrict__ cb, Color col, Sched sched,
                 Work wk, float* __restrict__ dx, float* __restrict__ d_dirs,
                 float* __restrict__ d_a) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile<T> t{smem};
  Stream<T> s = start_stream(sched, w, cw, t);
  const long long p0 = (long long)blockIdx.x * C::P;
  const int n_valid = (int)min(n_pts - p0, (long long)C::P);  // the tile's real points
  const int L = net.L, CL = col.n_layers, S = col.n_static, base = 6 * L;
  auto G = [&](int i) { return wk.slot(base + CL + 1 + i, p0); };
  const ColorRows rows{&wk, base, p0};

  // the cotangents: c_grad into t.cg, c_sdf / scale into column 0 of the
  // SDF output's
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    const bool ok = p < n_valid;
    for (int a = 0; a < 3; ++a) t.cg()[p * 3 + a] = ok ? cot[(p0 + p) * 7 + 4 + a] : 0.0f;
    wk.at(KG, L - 1, p0)[(long long)p * WMAX] = ok ? cot[(p0 + p) * 7 + 3] / net.scale : 0.0f;
  }

  // the forward: F, the feature, the static head, G, lin0 .. rgb
  tile_pe(pts + p0 * 3, n_valid, net, wk, p0, t, true);
  tile_F(net, b, wk, p0, s, t, true);
  sdf_out_layer(net, w, b, col, s, t, rows.O(), nullptr, n_valid);
  color_static(col, cb, s, t, dirs + p0 * 3, app + p0 * col.n_a, n_valid, rows);
  tile_G(net, w, wk, p0, s, t, true);
  {
    auto e = [&] {
      return SigmoidGradEpi<T>{t, cb + col.b_off[CL - 1], cot + p0 * 7, G(CL - 1), n_valid};
    };
    color_lin(net, col, cb, s, t, pts + p0 * 3, n_valid, rows, nullptr, e);
    zero_cols(t.act(), 3, col.npad[CL - 1]);
  }

  // the colour head backward, r = g W per layer
  for (int i = CL - 1; i >= 2; --i) {
    if (i == 1 + S) {
      auto e = [&] { return Lin0BackEpi<T>{t, G(S), rows.in(1 + S), col.k[1 + S]}; };
      tgemm(s, t, t.act(), C::AST, e);
    } else {
      auto e = [&] { return MaskEpi<T>{t, G(i - 1), rows.in(i), col.n[i - 1]}; };
      tgemm(s, t, t.act(), C::AST, e);
    }
    zero_cols(t.act(), col.n[i - 1], col.npad[i - 1]);
  }
  // the static head's first input: the columns past NMAX first
  for (int j0 = ((col.k[1] - 1) / NMAX) * NMAX; j0 >= 0; j0 -= NMAX) {
    auto e = [&] {
      return Static0BackEpi<T>{t, G(0), d_a + p0 * col.n_a, col.n[0], col.d_view, col.n_a, j0,
                               n_valid};
    };
    tgemm(s, t, t.act(), C::AST, e);
  }
  {
    auto e = [&] { return FeatEpi{wk.at(KG, L - 1, p0), col.k[0]}; };
    tgemm(s, t, t.act(), C::AST, e);
  }
  // d_dirs through the view PE's Jacobian
  for (int p = threadIdx.x; p < C::P && p < n_valid; p += C::THREADS) {
    float d[3], g[3];
    for (int a = 0; a < 3; ++a) d[a] = dirs[(p0 + p) * 3 + a];
    pe_jac_T(d, col.multires_view, t.ghat() + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) d_dirs[(p0 + p) * 3 + a] = g[a];
  }

  // the SDF's second-order backward with the colour cotangents injected
  tile_backward(net, wk, p0, s, t);
  for (int p = threadIdx.x; p < C::P && p < n_valid; p += C::THREADS)
    for (int a = 0; a < 3; ++a) dx[(p0 + p) * 3 + a] = t.dxs()[p * 3 + a] + t.aux()[p * 3 + a];
}

template <typename T>
int launch(const float* pts, const float* dirs, const float* app, const float* cot,
           long long n_pts, const void* w, const float* b, const Net& net, const void* cw,
           const float* cb, const Color& col, const Sched& sched, const Work& wk, float* dx,
           float* d_dirs, float* d_a, cudaStream_t s) {
  auto kern = field_bwd_kernel<T>;
  constexpr size_t smem = tile_bytes<T>();
  if (int err = prepare(kern, smem)) return err;
  kern<<<(unsigned)((n_pts + Cfg<T>::P - 1) / Cfg<T>::P), Cfg<T>::THREADS, smem, s>>>(
      pts, dirs, app, cot, n_pts, static_cast<const T*>(w), b, net, static_cast<const T*>(cw), cb,
      col, sched, wk, dx, d_dirs, d_a);
  return (int)cudaGetLastError();
}

}  // namespace

// nw_field_bwd's parameters, and its body for one activation dtype. Each
// dtype's kernel builds from a source of its own, so that the two
// instantiations, which take most of the kernels' build, compile in
// parallel: this file builds the bfloat16 one and the entry, and
// field_bwd_f32.cu includes it with NW_FIELD_BWD_F32 defined for the float
// one (nw::field_bwd_f32).
#define NW_FIELD_BWD_PARAMS                                                                    \
  const float* pts, const float* dirs, const float* app, const float* cot, long long n_pts,      \
      const void* w, const float* b, int bf16_act, int n_layers, int multires, float scale,     \
      int skip_mask, const int* k, const int* n, const int* kpad, const int* npad,              \
      const long long* w_off, const long long* wt_off, const int* b_off, const void* cw,        \
      const float* cb, int c_layers, int n_static, int multires_view, int n_a, const int* ck,   \
      const int* cn, const int* ckpad, const int* cnpad, const long long* cw_off,               \
      const long long* cwt_off, const int* cb_off, float* work, long long work_rows,            \
      int work_slots, float* dx, float* d_dirs, float* d_a, void* stream
#define NW_FIELD_BWD_ARGS                                                                       \
  pts, dirs, app, cot, n_pts, w, b, bf16_act, n_layers, multires, scale, skip_mask, k, n, kpad,  \
      npad, w_off, wt_off, b_off, cw, cb, c_layers, n_static, multires_view, n_a, ck, cn, ckpad, \
      cnpad, cw_off, cwt_off, cb_off, work, work_rows, work_slots, dx, d_dirs, d_a, stream

namespace {

template <typename ActT>
int field_bwd_as(NW_FIELD_BWD_PARAMS) {
  Net net;
  Color col;
  if (make_net(n_layers, multires, scale, skip_mask, k, n, kpad, npad, w_off, wt_off, b_off,
               &net) ||
      make_color(c_layers, n_static, multires_view, n_a, n[n_layers - 1] - 1, ck, cn, ckpad,
                 cnpad, cw_off, cwt_off, cb_off, &col) ||
      !color_fits<ActT>(col) ||
      work_rows < ((n_pts + 63) / 64) * 64 ||
      work_slots < 6 * n_layers + color_slots(c_layers))
    return -1;
  SchedMaker sb;
  sb.F(net);
  sb.last(net);
  color_fwd_sched(sb, col, 0, n_static + 1);
  sb.G(net);
  color_fwd_sched(sb, col, n_static + 1, c_layers);
  for (int i = c_layers - 1; i >= 2; --i)
    sb.add(1, col.wt_off[i], col.npad[i], col.kpad[i], col.npad[i]);
  for (int j0 = ((col.k[1] - 1) / NMAX) * NMAX; j0 >= 0; j0 -= NMAX) {
    const int rows = col.kpad[1] - j0 < NMAX ? col.kpad[1] - j0 : NMAX;
    sb.add(1, col.wt_off[1] + (long long)j0 * col.npad[1], col.npad[1], rows, col.npad[1]);
  }
  sb.add(1, col.wt_off[0], col.npad[0], col.kpad[0], col.npad[0]);
  sb.backward(net);
  if (!sb.ok) return -1;
  Work wk{work, work_rows, n_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts <= 0) return 0;
  return launch<ActT>(pts, dirs, app, cot, n_pts, w, b, net, cw, cb, col, sb.s, wk, dx, d_dirs,
                      d_a, s);
}

}  // namespace

namespace nw {
int field_bwd_f32(NW_FIELD_BWD_PARAMS);
}

#ifdef NW_FIELD_BWD_F32
int nw::field_bwd_f32(NW_FIELD_BWD_PARAMS) { return field_bwd_as<float>(NW_FIELD_BWD_ARGS); }
#else
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
  return bf16_act ? field_bwd_as<bf16>(NW_FIELD_BWD_ARGS)
                  : nw::field_bwd_f32(NW_FIELD_BWD_ARGS);
}
#endif
