// K10: the exact first / last-hit DDA through a flat occupancy grid, and
// K11: the sampled first-hit query; one thread per ray, both.
//
// Neither replaces a Pallas kernel: the JAX package's DDA is a
// lax.while_loop of whole-batch steps (neuralrecon_w_tpu/ops/ray_voxel.py:
// dda_traverse) and its sampled query an XLA gather over an (R, K)
// buffer (sampled_first_hit). Their plain PyTorch versions
// (ops/ray_voxel.py: dda_traverse_plain, sampled_first_hit_plain) are a
// Python loop of whole-batch ops and the (R, K, 3) buffer; on the card the
// first is bound by the host's launch rate (~20 launches a step, up to
// 3 * 2^L + 2 steps), the second by its buffer's bytes.
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
