// K10: the exact first / last-hit DDA through a flat occupancy grid,
// K11: the sampled first-hit query, and
// K12: the exact DDA through a two-level grid; one thread per ray, all three.
//
// None replaces a Pallas kernel: the JAX package's DDAs are
// lax.while_loops of whole-batch steps (neuralrecon_w_tpu/ops/ray_voxel.py:
// dda_traverse, dda_traverse_hier) and its sampled query an XLA gather
// over an (R, K) buffer (sampled_first_hit). Their plain PyTorch versions
// (ops/ray_voxel.py: dda_traverse_plain, dda_traverse_hier_plain,
// sampled_first_hit_plain) are Python loops of whole-batch ops and the
// (R, K, 3) buffer; on the card the loops are bound by the host's launch
// rate (~20-40 launches a step, up to 3 * 2^L + 2 steps), the buffer by its
// bytes.
//
// What bounds these kernels: device memory. A ray reads its 24 bytes of
// origin and direction, writes its results, and reads one 4-byte
// occupancy word a step (K10) or a sample (K11); the words are scattered
// over a bitfield of 2^{3L} / 8 bytes (128 MiB at level 10, above the 50 MB
// L2), so each read is a sector of its own unless neighbouring rays walk
// neighbouring cells, as the rays of one camera do. The design keeps a
// ray's whole march in registers (no (R, K) buffer, no per-step launch)
// and ends a ray's loop as soon as it is decided: at the grid's exit, or
// at the first hit where only that is asked.
//
// The results equal the plain versions bit for bit. So the arithmetic is
// theirs, operation for operation, in float32 with round-to-nearest, and
// written with __fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise
// contract a * b + c into one FMA (rounded once), and a tie at a cell
// boundary would go the other way. Division stays IEEE (nvcc's default
// -prec-div=true).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e10f;  // ops/ray_voxel.py's _INF

__device__ __forceinline__ bool occupied(const unsigned* __restrict__ occ, long long idx) {
  return (__ldg(occ + (idx >> 5)) >> (idx & 31)) & 1u;
}

__device__ __forceinline__ float clamp_cell(float x, int n) {
  return fminf(fmaxf(floorf(x), 0.0f), (float)(n - 1));
}

__global__ void __launch_bounds__(THREADS)
dda_kernel(const unsigned* __restrict__ occ, int level, const float* __restrict__ rays_o,
           const float* __restrict__ rays_d, long long n_rays, int first_only, int max_steps,
           float* __restrict__ t_first, float* __restrict__ t_last,
           unsigned char* __restrict__ hit, int* __restrict__ steps_out) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const int n = 1 << level;
  const float cell_w = 2.0f / (float)n;
  float o[3], d[3], inv[3], tmax[3], tdelta[3];
  long long idx_step[3];
  int left[3];
  float t_enter = -INFINITY, t_exit = INFINITY;
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
    if (fabsf(d[a]) < 1e-12f) d[a] = 1e-12f;
    inv[a] = 1.0f / d[a];
    const float t0 = __fmul_rn(__fsub_rn(-1.0f, o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(1.0f, o[a]), inv[a]);
    t_enter = fmaxf(t_enter, fminf(t0, t1));
    t_exit = fminf(t_exit, fmaxf(t0, t1));
  }
  t_enter = fmaxf(t_enter, 0.0f);
  bool active = t_exit > t_enter;
  const float t_in = __fadd_rn(t_enter, 1e-6f);
  const long long stride[3] = {(long long)n * n, n, 1};
  long long idx = 0;
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(o[a], __fmul_rn(d[a], t_in));
    const int cell = (int)clamp_cell(__fadd_rn(pos, 1.0f) / cell_w, n);
    const bool up = d[a] > 0.0f;
    const float bound = __fsub_rn(__fmul_rn((float)(cell + (up ? 1 : 0)), cell_w), 1.0f);
    tmax[a] = __fmul_rn(__fsub_rn(bound, o[a]), inv[a]);
    tdelta[a] = __fmul_rn(cell_w, fabsf(inv[a]));
    idx_step[a] = up ? stride[a] : -stride[a];
    left[a] = up ? n - 1 - cell : cell;
    idx = idx * n + cell;
  }
  const long long n_cells = (long long)n * n * n;
  float t_cur = t_enter, first = BIG, last = -BIG;
  int i = 0;
  for (; i < max_steps && active; ++i) {
    const long long at = idx < 0 ? 0 : (idx >= n_cells ? n_cells - 1 : idx);
    if (occupied(occ, at)) {
      if (first >= BIG) first = t_cur;
      last = t_cur;
    }
    int a = 0;  // argmin, the first axis on ties
    if (tmax[1] < tmax[a]) a = 1;
    if (tmax[2] < tmax[a]) a = 2;
    const float t_next = tmax[a];
    tmax[a] = __fadd_rn(tmax[a], tdelta[a]);
    idx += idx_step[a];
    left[a] -= 1;
    active = left[a] >= 0 && t_next <= t_exit;
    if (first_only) active = active && first >= BIG;
    t_cur = t_next;
  }
  const bool h = first < BIG;
  t_first[r] = h ? first : 0.0f;
  t_last[r] = h ? last : 0.0f;
  hit[r] = h;
  if (steps_out) steps_out[r] = i;
}

__global__ void __launch_bounds__(THREADS)
sampled_hit_kernel(const unsigned* __restrict__ occ, int level, const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d, const float* __restrict__ t_lo,
                   const float* __restrict__ t_hi, const float* __restrict__ rel, int n_samples,
                   long long n_rays, float* __restrict__ t_first, unsigned char* __restrict__ hit,
                   int* __restrict__ steps_out) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const int n = 1 << level;
  const float half_n = (float)n / 2.0f;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
  }
  const float lo = t_lo[r];
  const float span = __fsub_rn(t_hi[r], lo);
  float found = 0.0f;
  bool h = false;
  int k = 0;
  while (k < n_samples && !h) {
    const float t = __fadd_rn(lo, __fmul_rn(span, __ldg(rel + k)));
    bool inside = true;
    long long idx = 0;
    for (int a = 0; a < 3; ++a) {
      const float p = __fadd_rn(o[a], __fmul_rn(d[a], t));
      inside = inside && fabsf(p) < 1.0f;
      idx = idx * n + (long long)clamp_cell(__fmul_rn(__fadd_rn(p, 1.0f), half_n), n);
    }
    ++k;
    if (inside && occupied(occ, idx)) {
      found = t;
      h = true;
    }
  }
  t_first[r] = found;
  hit[r] = h;
  if (steps_out) steps_out[r] = k;
}

// K12. The grid is two levels (ops/ray_voxel.py's HierGrid): meta holds, per
// 32 blocks of 8^3 cells, the coarse occupancy word and the rank of its
// first block among the occupied ones; fine holds 16 words (512 bits) per
// occupied block, in rank order. A step probes the point eps past the
// current entry, takes its fine cell and block, reads the block's meta row
// and, in an occupied block, one fine word at slot rank + popc(word &
// ((1 << bit) - 1)). It then advances to the exit of the fine cell inside an
// occupied block and of the whole block through an empty one, the exit
// recomputed from the cell at that granularity (no incremental tmax), as
// JAX's dda_traverse_hier does. A ray reads an 8-byte meta row a step and a
// 4-byte fine word a step inside occupied blocks: at level 12 meta is 32 MiB
// and fine 64 B a block, so the rays of one camera share rows in L2 while a
// flat level-12 bitfield (8 GiB) could not be held at all. The arithmetic is
// dda_traverse_hier_plain's, operation for operation (see above for the _rn
// spelling); eps = eps_c / max|d| is an IEEE division, as the plain version's
// tensor division is.
__global__ void __launch_bounds__(THREADS)
dda_hier_kernel(const uint2* __restrict__ meta, const unsigned* __restrict__ fine,
                long long n_fine, int level, const float* __restrict__ rays_o,
                const float* __restrict__ rays_d, long long n_rays, int first_only,
                int max_steps, float eps_c, float* __restrict__ t_first,
                float* __restrict__ t_last, unsigned char* __restrict__ hit,
                int* __restrict__ steps_out) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const int n_f = 1 << level, n_c = n_f >> 3;
  const float w_f = 2.0f / (float)n_f, w_c = 2.0f / (float)n_c;
  const float inv_wf = (float)n_f / 2.0f;  // exact: w_f is a power of two
  float o[3], d[3], inv[3];
  float t_enter = -INFINITY, t_leave = INFINITY, dmax = 0.0f;
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
    if (fabsf(d[a]) < 1e-12f) d[a] = 1e-12f;
    inv[a] = 1.0f / d[a];
    const float t0 = __fmul_rn(__fsub_rn(-1.0f, o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(1.0f, o[a]), inv[a]);
    t_enter = fmaxf(t_enter, fminf(t0, t1));
    t_leave = fminf(t_leave, fmaxf(t0, t1));
    dmax = fmaxf(dmax, fabsf(d[a]));
  }
  t_enter = fmaxf(t_enter, 0.0f);
  bool active = t_leave > t_enter;
  const float eps = eps_c / dmax;
  float t_cur = t_enter, first = BIG, last = -BIG;
  int i = 0;
  for (; i < max_steps && active; ++i) {
    const float tt = __fadd_rn(t_cur, eps);
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float p = __fadd_rn(o[a], __fmul_rn(d[a], tt));
      c[a] = (int)clamp_cell(__fmul_rn(__fadd_rn(p, 1.0f), inv_wf), n_f);
    }
    const long long bidx = ((long long)(c[0] >> 3) * n_c + (c[1] >> 3)) * n_c + (c[2] >> 3);
    const uint2 row = __ldg(meta + (bidx >> 5));
    const unsigned bit = (unsigned)(bidx & 31);
    const bool blk = (row.x >> bit) & 1u;
    if (blk) {
      const long long slot = (long long)row.y + __popc(row.x & ((1u << bit) - 1u));
      const int fidx = ((c[0] & 7) * 8 + (c[1] & 7)) * 8 + (c[2] & 7);
      long long at = slot * 16 + (fidx >> 5);
      at = at < 0 ? 0 : (at >= n_fine ? n_fine - 1 : at);
      if ((__ldg(fine + at) >> (fidx & 31)) & 1u) {
        if (first >= BIG) first = t_cur;
        last = t_cur;
      }
    }
    // the exit of the fine cell (occupied block) or of the block (empty one)
    float t_ex = INFINITY;
    for (int a = 0; a < 3; ++a) {
      const int cg = blk ? c[a] : (c[a] >> 3);
      const float w_g = blk ? w_f : w_c;
      const float hi = __fsub_rn(__fmul_rn((float)(cg + (d[a] > 0.0f ? 1 : 0)), w_g), 1.0f);
      t_ex = fminf(t_ex, __fmul_rn(__fsub_rn(hi, o[a]), inv[a]));
    }
    const float t_next = fmaxf(t_ex, tt);  // at least eps of progress
    active = t_next < t_leave;
    if (first_only) active = active && first >= BIG;
    t_cur = t_next;
  }
  const bool h = first < BIG;
  t_first[r] = h ? first : 0.0f;
  t_last[r] = h ? last : 0.0f;
  hit[r] = h;
  if (steps_out) steps_out[r] = i;
}

}  // namespace

// (t_first, t_last, hit) of rays (R, 3) + (R, 3) float32 in grid-normalised
// coordinates through the level-`level` bitfield; steps_out (R,) int32 or
// null: the loop trips of each ray.
extern "C" int nw_dda(const void* occ, int level, const float* rays_o, const float* rays_d,
                      long long n_rays, int first_only, int max_steps, float* t_first,
                      float* t_last, unsigned char* hit, int* steps_out, void* stream) {
  if (level < 0 || level > 20 || max_steps < 0) return -1;
  if (n_rays <= 0) return 0;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  dda_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(occ), level, rays_o, rays_d, n_rays, first_only, max_steps,
      t_first, t_last, hit, steps_out);
  return (int)cudaGetLastError();
}

// (t_first, hit) of the first occupied sample t = t_lo + (t_hi - t_lo) rel[k]
// inside the cube, k = 0 .. n_samples - 1 in order; steps_out: samples walked.
extern "C" int nw_sampled_hit(const void* occ, int level, const float* rays_o,
                              const float* rays_d, const float* t_lo, const float* t_hi,
                              const float* rel, int n_samples, long long n_rays, float* t_first,
                              unsigned char* hit, int* steps_out, void* stream) {
  if (level < 0 || level > 20 || n_samples < 1) return -1;
  if (n_rays <= 0) return 0;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  sampled_hit_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(occ), level, rays_o, rays_d, t_lo, t_hi, rel, n_samples,
      n_rays, t_first, hit, steps_out);
  return (int)cudaGetLastError();
}

// K12: (t_first, t_last, hit) of rays through the two-level grid of a
// level-`level` occupancy (meta: (2^{3(level-3)} / 32, 2) words, fine:
// n_fine words); eps_c = 2^{1-level} * 1e-3 as float32.
extern "C" int nw_dda_hier(const void* meta, const void* fine, long long n_fine, int level,
                           const float* rays_o, const float* rays_d, long long n_rays,
                           int first_only, int max_steps, float eps_c, float* t_first,
                           float* t_last, unsigned char* hit, int* steps_out, void* stream) {
  if (level < 3 || level > 20 || max_steps < 0 || n_fine < 16) return -1;
  if (n_rays <= 0) return 0;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  dda_hier_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(meta), static_cast<const unsigned*>(fine), n_fine, level, rays_o,
      rays_d, n_rays, first_only, max_steps, eps_c, t_first, t_last, hit, steps_out);
  return (int)cudaGetLastError();
}
