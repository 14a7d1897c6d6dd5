// The host geometry of mesh extraction and evaluation, the port's copy of
// two entries of the JAX package's csrc/geometry.cpp, compiled by
// ops/native.py with g++ at first use and loaded with ctypes. Host code,
// not device kernels: the TPU package ran them on the host too.
//
//   * nw_marching_tetrahedra: marching tetrahedra over a dense float field
//     with the 8-corner validity mask, emitting a deduplicated indexed
//     mesh; its plain version is ops/isosurface.py.
//   * nw_rasterize_depth: the z-buffer triangle rasteriser of the
//     reprojection filter's mesh mode, with near-plane clipping; its plain
//     version is evaluation/reproj_filter._rasterize_depth_numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>


// ---------------------------------------------------------------------------
// Marching tetrahedra
// ---------------------------------------------------------------------------

namespace {

const int kTets[6][4] = {{0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
                         {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7}};
const int kCorner[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                           {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// tri table: for each 4-bit "inside" mask, up to 2 triangles of
// tet-edge indices (-1 padded). Mirrors ops/isosurface.py.
int kTriTable[16][2][3];
bool kTriInit = false;

void init_tri_table() {
  for (int m = 0; m < 16; ++m)
    for (int t = 0; t < 2; ++t)
      for (int e = 0; e < 3; ++e) kTriTable[m][t][e] = -1;
  auto set1 = [](int m, int a, int b, int c) {
    kTriTable[m][0][0] = a; kTriTable[m][0][1] = b; kTriTable[m][0][2] = c;
  };
  auto set2 = [](int m, int a, int b, int c, int d, int e, int f) {
    kTriTable[m][0][0] = a; kTriTable[m][0][1] = b; kTriTable[m][0][2] = c;
    kTriTable[m][1][0] = d; kTriTable[m][1][1] = e; kTriTable[m][1][2] = f;
  };
  set1(0b0001, 0, 1, 2);
  set1(0b0010, 0, 4, 3);
  set1(0b0100, 1, 3, 5);
  set1(0b1000, 2, 5, 4);
  set2(0b0011, 1, 4, 3, 1, 2, 4);
  set2(0b0101, 0, 3, 5, 0, 5, 2);
  set2(0b1001, 0, 1, 5, 0, 5, 4);
  set2(0b0110, 0, 4, 5, 0, 5, 1);
  set2(0b1010, 0, 2, 5, 0, 5, 3);
  set2(0b1100, 1, 3, 4, 1, 4, 2);
  // complements with reversed winding
  for (int m = 1; m < 15; ++m) {
    int comp = (~m) & 0xF;
    if (kTriTable[m][0][0] >= 0 && kTriTable[comp][0][0] < 0) {
      for (int t = 0; t < 2; ++t) {
        if (kTriTable[m][t][0] < 0) continue;
        kTriTable[comp][t][0] = kTriTable[m][t][2];
        kTriTable[comp][t][1] = kTriTable[m][t][1];
        kTriTable[comp][t][2] = kTriTable[m][t][0];
      }
    }
  }
  kTriInit = true;
}

}  // namespace

// Extract the `level` isosurface of a dense (d0, d1, d2) float field.
// mask (uint8, same shape) may be null; a cell is processed only when
// all 8 corners are valid. Outputs:
//   out_verts: up to max_verts * 3 doubles (grid-index coordinates)
//   out_faces: up to max_faces * 3 int64
// Returns 0 on success (writing counts via n_verts/n_faces), -1 if the
// buffers were too small.
extern "C" int nw_marching_tetrahedra(
    const float* sdf, const uint8_t* mask,
    int64_t d0, int64_t d1, int64_t d2, float level,
    double* out_verts, int64_t max_verts,
    int64_t* out_faces, int64_t max_faces,
    int64_t* n_verts, int64_t* n_faces) {
  if (!kTriInit) init_tri_table();
  const int64_t s0 = d1 * d2, s1 = d2;
  auto gid = [&](int64_t x, int64_t y, int64_t z) { return x * s0 + y * s1 + z; };

  std::unordered_map<uint64_t, int64_t> edge_to_vert;
  edge_to_vert.reserve(1 << 16);
  int64_t vcount = 0, fcount = 0;

  auto edge_vertex = [&](int64_t ga, int64_t gb) -> int64_t {
    int64_t lo = ga < gb ? ga : gb, hi = ga < gb ? gb : ga;
    uint64_t key = (uint64_t(lo) << 32) | uint64_t(hi);
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    const float va = sdf[lo], vb = sdf[hi];
    double t = 0.5;
    const double denom = double(vb) - double(va);
    if (std::fabs(denom) > 1e-12) t = (double(level) - va) / denom;
    if (t < 0.0) t = 0.0;
    if (t > 1.0) t = 1.0;
    const double ax = double(lo / s0), ay = double((lo / s1) % d1),
                 az = double(lo % d2);
    const double bx = double(hi / s0), by = double((hi / s1) % d1),
                 bz = double(hi % d2);
    if (vcount >= max_verts) return -1;
    out_verts[3 * vcount] = ax + t * (bx - ax);
    out_verts[3 * vcount + 1] = ay + t * (by - ay);
    out_verts[3 * vcount + 2] = az + t * (bz - az);
    edge_to_vert.emplace(key, vcount);
    return vcount++;
  };

  for (int64_t x = 0; x + 1 < d0; ++x)
    for (int64_t y = 0; y + 1 < d1; ++y)
      for (int64_t z = 0; z + 1 < d2; ++z) {
        int64_t g[8];
        bool valid = true;
        int inside_any = 0, inside_all = 1;
        for (int c = 0; c < 8; ++c) {
          g[c] = gid(x + kCorner[c][0], y + kCorner[c][1], z + kCorner[c][2]);
          if (mask && !mask[g[c]]) valid = false;
          const int in = sdf[g[c]] < level ? 1 : 0;
          inside_any |= in;
          inside_all &= in;
        }
        if (!valid || !inside_any || inside_all) continue;

        for (int t = 0; t < 6; ++t) {
          int tmask = 0;
          for (int c = 0; c < 4; ++c)
            if (sdf[g[kTets[t][c]]] < level) tmask |= 1 << c;
          for (int tri = 0; tri < 2; ++tri) {
            if (kTriTable[tmask][tri][0] < 0) continue;
            int64_t vid[3];
            bool ok = true;
            for (int e = 0; e < 3; ++e) {
              const int* ed = kTetEdges[kTriTable[tmask][tri][e]];
              vid[e] = edge_vertex(g[kTets[t][ed[0]]], g[kTets[t][ed[1]]]);
              if (vid[e] < 0) return -1;
            }
            if (vid[0] == vid[1] || vid[1] == vid[2] || vid[0] == vid[2])
              ok = false;
            if (!ok) continue;
            if (fcount >= max_faces) return -1;
            out_faces[3 * fcount] = vid[0];
            out_faces[3 * fcount + 1] = vid[1];
            out_faces[3 * fcount + 2] = vid[2];
            ++fcount;
          }
        }
      }

  *n_verts = vcount;
  *n_faces = fcount;
  return 0;
}


// ---------------------------------------------------------------------------
// Depth rasteriser
// ---------------------------------------------------------------------------

// Perspective z-buffer triangle rasteriser: the mesh depth of one training
// camera (the reference's pyrender offscreen pass,
// utils/pyrender_renderer.py:4-39), per-pixel z-depth, 0 = miss.
//
// c2w is the 3x4 NeRF-convention (right, up, back) camera-to-world matrix
// (datasets/rays.py); points go to CV camera coordinates (z forward), so the
// depth matches the reference's reproject() (utils/reproj_filter.py:133-152):
// pc_cam = K^-1 [u, v, 1]^T * depth. Triangles are clipped against the near
// plane z = znear before projection; 1/z is interpolated linearly in screen
// space (perspective-correct depth).
extern "C" void nw_rasterize_depth(
    const double* verts, int64_t n_verts,
    const int64_t* faces, int64_t n_faces,
    const double* c2w,  // 3x4 row-major
    double fx, double fy, double cx, double cy,
    int64_t width, int64_t height, double znear,
    float* depth /* h*w, pre-filled by caller (0) */) {
  (void)n_verts;
  // world -> CV camera: x_cam = diag(1,-1,-1) * R^T * (X - t)
  const double R[9] = {c2w[0], c2w[1], c2w[2],  c2w[4], c2w[5], c2w[6],
                       c2w[8], c2w[9], c2w[10]};
  const double t[3] = {c2w[3], c2w[7], c2w[11]};

  std::vector<float> zbuf(size_t(width) * height,
                          std::numeric_limits<float>::infinity());

  auto to_cam = [&](const double* p, double* out) {
    const double dx = p[0] - t[0], dy = p[1] - t[1], dz = p[2] - t[2];
    const double xc = R[0] * dx + R[3] * dy + R[6] * dz;
    const double yc = R[1] * dx + R[4] * dy + R[7] * dz;
    const double zc = R[2] * dx + R[5] * dy + R[8] * dz;
    out[0] = xc;
    out[1] = -yc;
    out[2] = -zc;  // CV: z forward
  };

  auto raster_tri = [&](const double* a, const double* b, const double* c) {
    // project (camera -> pixel)
    const double pa[2] = {fx * a[0] / a[2] + cx, fy * a[1] / a[2] + cy};
    const double pb[2] = {fx * b[0] / b[2] + cx, fy * b[1] / b[2] + cy};
    const double pc[2] = {fx * c[0] / c[2] + cx, fy * c[1] / c[2] + cy};
    const double area = (pb[0] - pa[0]) * (pc[1] - pa[1]) -
                        (pb[1] - pa[1]) * (pc[0] - pa[0]);
    if (std::abs(area) < 1e-12) return;
    const double inv_area = 1.0 / area;
    const double iza = 1.0 / a[2], izb = 1.0 / b[2], izc = 1.0 / c[2];

    int64_t x0 = int64_t(std::floor(std::min({pa[0], pb[0], pc[0]})));
    int64_t x1 = int64_t(std::ceil(std::max({pa[0], pb[0], pc[0]})));
    int64_t y0 = int64_t(std::floor(std::min({pa[1], pb[1], pc[1]})));
    int64_t y1 = int64_t(std::ceil(std::max({pa[1], pb[1], pc[1]})));
    x0 = std::max<int64_t>(x0, 0);
    y0 = std::max<int64_t>(y0, 0);
    x1 = std::min<int64_t>(x1, width - 1);
    y1 = std::min<int64_t>(y1, height - 1);
    for (int64_t y = y0; y <= y1; ++y)
      for (int64_t x = x0; x <= x1; ++x) {
        const double px = double(x), py = double(y);
        const double w0 = ((pb[0] - px) * (pc[1] - py) -
                           (pb[1] - py) * (pc[0] - px)) * inv_area;
        const double w1 = ((pc[0] - px) * (pa[1] - py) -
                           (pc[1] - py) * (pa[0] - px)) * inv_area;
        const double w2 = 1.0 - w0 - w1;
        if (w0 < 0.0 || w1 < 0.0 || w2 < 0.0) continue;
        const double iz = w0 * iza + w1 * izb + w2 * izc;
        const float z = float(1.0 / iz);
        float& zb = zbuf[size_t(y) * width + x];
        if (z < zb) zb = z;
      }
  };

  // near-plane clip: emit the (0, 1 or 2)-triangle intersection of the
  // camera-space triangle with the half-space z >= znear
  auto clip_and_raster = [&](double v[3][3]) {
    int inside[3], n_in = 0;
    for (int i = 0; i < 3; ++i) {
      inside[i] = v[i][2] >= znear;
      n_in += inside[i];
    }
    if (n_in == 0) return;
    if (n_in == 3) {
      raster_tri(v[0], v[1], v[2]);
      return;
    }
    auto lerp = [&](const double* p, const double* q, double* out) {
      const double s = (znear - p[2]) / (q[2] - p[2]);
      for (int k = 0; k < 3; ++k) out[k] = p[k] + s * (q[k] - p[k]);
    };
    if (n_in == 1) {
      const int i = inside[0] ? 0 : (inside[1] ? 1 : 2);
      const int j = (i + 1) % 3, k = (i + 2) % 3;
      double e1[3], e2[3];
      lerp(v[i], v[j], e1);
      lerp(v[i], v[k], e2);
      double tri[3][3];
      std::memcpy(tri[0], v[i], sizeof tri[0]);
      std::memcpy(tri[1], e1, sizeof tri[1]);
      std::memcpy(tri[2], e2, sizeof tri[2]);
      raster_tri(tri[0], tri[1], tri[2]);
    } else {  // n_in == 2
      const int i = !inside[0] ? 0 : (!inside[1] ? 1 : 2);
      const int j = (i + 1) % 3, k = (i + 2) % 3;
      double e1[3], e2[3];
      lerp(v[j], v[i], e1);
      lerp(v[k], v[i], e2);
      raster_tri(v[j], v[k], e1);
      raster_tri(v[k], e2, e1);
    }
  };

  for (int64_t f = 0; f < n_faces; ++f) {
    double v[3][3];
    for (int c = 0; c < 3; ++c)
      to_cam(verts + 3 * faces[3 * f + c], v[c]);
    clip_and_raster(v);
  }

  for (int64_t i = 0; i < int64_t(width) * height; ++i)
    depth[i] = std::isinf(zbuf[i]) ? 0.0f : zbuf[i];
}
