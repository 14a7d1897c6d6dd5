// The host mesher of mesh extraction: marching tetrahedra over a dense
// float field with the 8-corner validity mask, emitting a deduplicated
// indexed mesh. The port's copy of the nw_marching_tetrahedra entry of the
// JAX package's csrc/geometry.cpp (and its table), compiled by
// ops/native.py with g++ at first use and loaded with ctypes. Host code,
// not a device kernel: the TPU package ran it on the host too. Its plain
// version is ops/isosurface.py.

#include <cmath>
#include <cstdint>
#include <unordered_map>


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
