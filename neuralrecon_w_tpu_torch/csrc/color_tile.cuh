// The colour head's tile pass, shared by K6 (field_fwd.cu) and K7
// (field_bwd.cu): the IDR colour net with the appearance head over one tile
// of points, as tile GEMMs (sdf_tile.cuh) with fused epilogues, on
// [x, grad, relu-static-head(xyz_final(feature), PE_view(dirs), a)].
//
// Layer 0 is xyz_final, 1 .. S the static head, then lin0 ... The static
// head's first layer takes [xyz_final | PE_view | a], 587 wide at the
// brandenburg width, past the workspace row: it runs as two products into
// one f32 sum, the second over columns n[0].. of the same packed weight.
#pragma once

#include "sdf_tile.cuh"

namespace {

constexpr int CMAXL = 16;

struct Color {  // layer 0 xyz_final, 1 .. S the static head, then lin0 ..
  int n_layers, n_static, multires_view, d_view, n_a;
  int k[CMAXL], n[CMAXL], kpad[CMAXL], npad[CMAXL], b_off[CMAXL];
  long long w_off[CMAXL], wt_off[CMAXL];
};

struct LinEpi {  // out = acc + b, optionally through a ReLU
  const float* b; float* out; bool relu;
  __device__ void operator()(int p, int j, float acc) const {
    const float z = acc + b[j];
    out[(long long)p * WMAX + j] = relu ? fmaxf(z, 0.0f) : z;
  }
};

struct StoreEpi {  // a partial sum
  float* out;
  __device__ void operator()(int p, int j, float acc) const { out[(long long)p * WMAX + j] = acc; }
};

struct SumReluEpi {  // relu(acc + partial + b)
  const float* b; const float* part; float* out;
  __device__ void operator()(int p, int j, float acc) const {
    const long long o = (long long)p * WMAX + j;
    out[o] = fmaxf(acc + part[o] + b[j], 0.0f);
  }
};

// Where the colour layers of a tile read and write (rows of the workspace,
// offset to the tile): feat is the SDF's output row [sdf * scale | feature]
// (xyz_final reads columns 1..), view [PE_view(dirs) | a], part the static
// head's first product, in[i] layer i's input for i >= 1 (in[1] the
// xyz_final part of the static head's). Layer i writes in[i + 1], the last
// static layer columns 6.. of lin0's input (after [x, grad]).
struct ColorRows {
  const float* feat;
  float* view;
  float* part;
  float* in[CMAXL];
};

// The colour head over the tile, the last layer through `last` (which adds
// its bias itself). in[1 + S]'s first 6 columns, view and feat are staged.
template <typename T, class Last>
__device__ void color_forward(const T* cw, const float* cb, const Color& col, const ColorRows& r,
                              float* sm, Last& last) {
  const int S = col.n_static, C = col.n_layers;
  auto out_of = [&](int i) { return i == S ? r.in[1 + S] + 6 : r.in[i + 1]; };
  {
    LinEpi e{cb + col.b_off[0], r.in[1], false};
    gemm(r.feat + 1, col.k[0], cw + col.w_off[0], col.kpad[0], col.n[0], sm, e);
  }
  {
    StoreEpi e1{r.part};
    gemm(r.in[1], col.n[0], cw + col.w_off[1], col.kpad[1], col.n[1], sm, e1);
    SumReluEpi e2{cb + col.b_off[1], r.part, out_of(1)};
    gemm(r.view, col.d_view + col.n_a, cw + col.w_off[1] + col.n[0], col.kpad[1], col.n[1], sm,
         e2);
  }
  for (int i = 2; i < C - 1; ++i) {
    LinEpi e{cb + col.b_off[i], out_of(i), true};
    gemm(r.in[i], col.k[i], cw + col.w_off[i], col.kpad[i], col.n[i], sm, e);
  }
  gemm(r.in[C - 1], col.k[C - 1], cw + col.w_off[C - 1], col.kpad[C - 1], col.n[C - 1], sm, last);
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
    col->npad[i] = npad ? npad[i] : 0;
    col->w_off[i] = w_off[i];
    col->wt_off[i] = wt_off ? wt_off[i] : 0;
    col->b_off[i] = b_off[i];
  }
  // widths the workspace rows hold; the static head's second product starts
  // at column n[0] of its weight, 16-byte aligned in bf16
  if (n[0] != d_feat || d_feat + 1 > WMAX || n[0] % 8 || d_view + n_a > WMAX ||
      6 + n[n_static] > WMAX || n[n_layers - 1] != 3)
    return -1;
  return 0;
}

}  // namespace
