// The colour head's tile pass, shared by K6 (field_fwd.cu) and K7
// (field_bwd.cu): the SDF's last layer into the feature, then the IDR
// colour net with the appearance head over one tile of points on
// [x, grad, relu-static-head(xyz_final(feature), PE_view(dirs), a)], as
// tile GEMMs over the shared-memory operand (sdf_tile.cuh).
//
// Layer 0 is xyz_final, 1 .. S the static head, then lin0 ... The static
// head's first layer takes [xyz_final | PE_view | a], 587 wide at the
// brandenburg width, past the operand row: it runs as one product whose
// columns from n[0] on come from a second operand, the tile's
// [PE_view | a] (the view buffer). The static head runs before G (which
// needs the operand), its output waiting in a stash; lin0 follows G, which
// gives grad. The view buffer and the stash live in the tile's spare
// shared memory (ghat, pehat), which only tile_backward needs.
#pragma once

#include "sdf_tile.cuh"

namespace {

constexpr int CMAXL = 16;

struct Color {  // layer 0 xyz_final, 1 .. S the static head, then lin0 ..
  int n_layers, n_static, multires_view, d_view, n_a;
  int k[CMAXL], n[CMAXL], kpad[CMAXL], npad[CMAXL], b_off[CMAXL];
  long long w_off[CMAXL], wt_off[CMAXL];
};

// the view buffer's row stride and the stash's
template <typename T> __host__ __device__ inline int view_st(const Color& c) {
  return c.kpad[1] - c.n[0] + Cfg<T>::PAD;
}
__host__ __device__ inline int stash_st(const Color& c) { return (c.n[c.n_static] + 1) & ~1; }

// K7's device rows of the colour head, slots of its workspace from slot
// `base` on, offset to the tile (K6: wk null, no rows). Computed where
// used, not held: an array of them sits on the stack and costs K7 registers.
// O() the SDF's output row [sdf * scale | feature] (xyz_final's input is
// columns 1..), V() [PE_view(dirs) | a], in(i) layer i's input for i >= 1
// (in(1 + S): [x, grad, h])
struct ColorRows {
  const Work* wk;  // null: none
  int base;
  long long p0;
  __device__ float* slot(int s) const { return wk ? wk->slot(base + s, p0) : nullptr; }
  __device__ float* O() const { return slot(0); }
  __device__ float* V() const { return slot(1); }
  __device__ float* in(int i) const { return slot(1 + i); }
};

template <typename T>
struct ActEpi {  // acc + b, through a ReLU if relu: into dst (row stride dst_st) and row + roff
  const float* b; T* dst; int dst_st; float* row; int roff, n; bool relu;
  __device__ void operator()(int p, int j, float a0, float a1) const {
    if (j >= n) return;
    float v0 = a0 + b[j], v1 = j + 1 < n ? a1 + b[j + 1] : 0.0f;
    if (relu) v0 = fmaxf(v0, 0.0f), v1 = fmaxf(v1, 0.0f);
    at2(dst + p * dst_st, j, n, v0, v1);
    if (row) st2(row + (long long)p * WMAX + roff, j, n, v0, v1);
  }
};

template <typename T>
struct FeatOutEpi {  // the SDF's last layer: column 0 -> sdf, the feature -> operand (and O)
  Tile<T> t; const float* b; float* O; float* sdf; float inv_scale; int n, n_valid;
  __device__ void one(int p, int j, float v) const {
    if (j >= n) return;
    if (j == 0) {
      if (sdf && p < n_valid) sdf[p] = v * inv_scale;
    } else {
      t.act()[p * Cfg<T>::AST + j - 1] = to_t<T>(v);
    }
  }
  __device__ void operator()(int p, int j, float a0, float a1) const {
    const float v0 = a0 + b[j], v1 = j + 1 < n ? a1 + b[j + 1] : 0.0f;
    one(p, j, v0);
    one(p, j + 1, v1);
    if (O) st2(O + (long long)p * WMAX, j, n, v0, v1);
  }
};

// The SDF's last layer from the operand u_{L-1}: the feature (columns 1..)
// over the operand, column 0 / scale into sdf (K6), every column into O
// (K7). Columns past NMAX wait in t.pehat() while the product runs.
template <typename T>
__device__ void sdf_out_layer(const Net& net, const T* w, const float* b, const Color& col,
                              Stream<T>& s, Tile<T>& t, float* O, float* sdf, int n_valid) {
  using C = Cfg<T>;
  const int l = net.L - 1, n = net.n[l], extra = n - NMAX;
  auto keep = [&](int p, int j, float v) { t.pehat()[p * PE_MAX + j - NMAX] = v; };
  last_tail(net, w, b, t, keep);
  auto e = [&] {
    return FeatOutEpi<T>{t, b + net.b_off[l], O, sdf, 1.0f / net.scale, n < NMAX ? n : NMAX,
                         n_valid};
  };
  tgemm(s, t, t.act(), C::AST, e);
  for (int e2 = threadIdx.x; e2 < C::P * (extra > 0 ? extra : 0); e2 += C::THREADS) {
    const int p = e2 / extra, j = NMAX + e2 - p * extra;
    const float v = t.pehat()[p * PE_MAX + j - NMAX];
    t.act()[p * C::AST + j - 1] = to_t<T>(v);
    if (O) O[(long long)p * WMAX + j] = v;
  }
  zero_cols(t.act(), n - 1, col.kpad[0]);
}

// xyz_final and the static head, after sdf_out_layer: the static head's
// output into the stash. Builds the view buffer (and V) from dirs and a.
template <typename T>
__device__ void color_static(const Color& col, const float* cb, Stream<T>& s, Tile<T>& t,
                             const float* dirs, const float* app, long long n_valid,
                             const ColorRows& r) {
  using C = Cfg<T>;
  const int S = col.n_static;
  T* view = static_cast<T*>(t.spare());
  T* stash = view;  // written only after the last read of the view buffer
  const int vst = view_st<T>(col), sst = stash_st(col), vw = col.kpad[1] - col.n[0];
  {
    auto e = [&] {
      return ActEpi<T>{cb + col.b_off[0], t.act(), C::AST, r.in(1), 0, col.n[0], false};
    };
    tgemm(s, t, t.act(), C::AST, e);
  }
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    const bool ok = p < n_valid;
    float d[3];
    for (int a = 0; a < 3; ++a) d[a] = ok ? dirs[(long long)p * 3 + a] : 0.0f;
    for (int c = 0; c < vw; ++c) {
      const float v = c < col.d_view ? pe_value(d, c)
                    : c < col.d_view + col.n_a && ok ? app[(long long)p * col.n_a + c - col.d_view]
                    : 0.0f;
      view[p * vst + c] = to_t<T>(v);
      if (r.V() && c < col.d_view + col.n_a) r.V()[(long long)p * WMAX + c] = v;
    }
  }
  for (int i = 1; i <= S; ++i) {
    const bool last = i == S;
    auto e = [&] {
      return ActEpi<T>{cb + col.b_off[i], last ? stash : t.act(), last ? sst : C::AST,
                       last ? r.in(1 + S) : r.in(i + 1), last ? 6 : 0, col.n[i], true};
    };
    if (i == 1) tgemm<true>(s, t, t.act(), C::AST, e, view, vst, col.n[0]);
    else tgemm(s, t, t.act(), C::AST, e);
    if (!last) zero_cols(t.act(), col.n[i], col.kpad[i + 1]);
  }
}

// After tile_G: lin0's input [x, grad, h] into the operand (and in[1 + S]),
// grad (and sdf's already written) out for the tile's real points (K6),
// then lin0 .. the last layer, which `last` takes (adding its own bias).
template <typename T, class Last>
__device__ void color_lin(const Net& net, const Color& col, const float* cb, Stream<T>& s,
                          Tile<T>& t, const float* pts, long long n_valid, const ColorRows& r,
                          float* grad, Last& last) {
  using C = Cfg<T>;
  const int S = col.n_static, CL = col.n_layers, hs = col.n[S], sst = stash_st(col);
  const T* stash = static_cast<const T*>(t.spare());
  float* I0 = r.in(1 + S);
  for (int p = threadIdx.x; p < C::P; p += C::THREADS) {
    const bool ok = p < n_valid;
    float g[3];
    pe_jac_T(t.xs() + p * 3, net.multires, t.gpe() + p * PE_MAX, g);
    for (int a = 0; a < 3; ++a) {
      const float x = ok ? pts[(long long)p * 3 + a] : 0.0f;
      t.act()[p * C::AST + a] = to_t<T>(x);
      t.act()[p * C::AST + 3 + a] = to_t<T>(g[a]);
      if (I0) I0[(long long)p * WMAX + a] = x, I0[(long long)p * WMAX + 3 + a] = g[a];
      if (grad && ok) grad[(long long)p * 3 + a] = g[a];
    }
  }
  {
    const int w = col.kpad[1 + S] - 6;
    for (int e = threadIdx.x; e < C::P * w; e += C::THREADS) {
      const int p = e / w, c = e - p * w;
      t.act()[p * C::AST + 6 + c] = c < hs ? stash[p * sst + c] : to_t<T>(0.0f);
    }
  }
  for (int i = 1 + S; i < CL - 1; ++i) {
    auto e = [&] {
      return ActEpi<T>{cb + col.b_off[i], t.act(), C::AST, r.in(i + 1), 0, col.n[i], true};
    };
    tgemm(s, t, t.act(), C::AST, e);
    zero_cols(t.act(), col.n[i], col.kpad[i + 1]);
  }
  tgemm(s, t, t.act(), C::AST, last);
}

// The colour table; npad and wt_off (the packed W^T, for K7's transposed
// products) may be null.
int make_color(int n_layers, int n_static, int multires_view, int n_a, int d_feat, const int* k,
               const int* n, const int* kpad, const int* npad, const long long* w_off,
               const long long* wt_off, const int* b_off, Color* col) {
  const int n_lin = n_layers - 1 - n_static;
  const int d_view = 3 * (1 + 2 * multires_view);
  if (n_layers > CMAXL || n_static < 1 || n_lin < 1 || multires_view < 0 || n_a < 0 ||
      d_view > PE_MAX)
    return -1;
  col->n_layers = n_layers;
  col->n_static = n_static;
  col->multires_view = multires_view;
  col->d_view = d_view;
  col->n_a = n_a;
  for (int i = 0; i < n_layers; ++i) {
    int want_k = i == 0 ? d_feat : i == 1 ? n[0] + d_view + n_a : i == 1 + n_static ? 6 + n[i - 1]
                                                                                      : n[i - 1];
    if (k[i] != want_k || n[i] <= 0 || n[i] > NMAX || kpad[i] != ((k[i] + 15) & ~15) ||
        w_off[i] % 8 || (npad && npad[i] != ((n[i] + 15) & ~15)) || (wt_off && wt_off[i] % 8))
      return -1;
    col->k[i] = k[i];
    col->n[i] = n[i];
    col->kpad[i] = kpad[i];
    col->npad[i] = (n[i] + 15) & ~15;
    col->w_off[i] = w_off[i];
    col->wt_off[i] = wt_off ? wt_off[i] : 0;
    col->b_off[i] = b_off[i];
  }
  // widths the operand and the workspace rows hold; the static head's
  // second operand starts at column n[0], a whole number of mma k-steps
  if (n[0] != d_feat || d_feat + 1 > WMAX || n[0] % 16 || d_view + n_a > WMAX ||
      kpad[1] - n[0] > NMAX || 6 + n[n_static] > NMAX || n[n_layers - 1] != 3)
    return -1;
  return 0;
}

// whether the view buffer and the stash fit the tile's spare shared memory
template <typename T>
bool color_fits(const Color& c) {
  const int st = view_st<T>(c) > stash_st(c) ? view_st<T>(c) : stash_st(c);
  return (size_t)Cfg<T>::P * st * sizeof(T) <= spare_bytes<T>();
}

// the colour head's forward GEMMs of layers [from, to): color_static runs
// 0 .. S, color_lin 1 + S ..
void color_fwd_sched(SchedMaker& sb, const Color& c, int from, int to) {
  for (int i = from; i < to; ++i) sb.add(1, c.w_off[i], c.kpad[i], c.npad[i], c.kpad[i]);
}

}  // namespace
