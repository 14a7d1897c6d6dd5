// K10: the exact first / last-hit DDA through a flat occupancy grid,
// K11: the sampled first-hit query, and
// K12: the exact DDA through a two-level grid.
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
// What bounds these kernels. Counted as bytes and operations the work is
// small: a ray reads its 24 bytes of origin and direction, writes its
// results, and tests one occupancy bit a step (K10) or a sample (K11), the
// words scattered over a bitfield of 2^{3L} / 8 bytes (128 MiB at level 10,
// above the 50 MB L2). What a ray walked by one thread meets instead is
// latency: a step's word must arrive before its bit is tested and the loop
// goes on, so a march is a chain of dependent memory round trips, and a
// served chunk of 8192 rays is too few threads to hide them. Each kernel
// keeps a ray's walk in registers (no (R, K) buffer, no launch a step) and
// ends it as soon as it is decided: at the grid's exit, or at the first hit
// where only that is asked. Then:
//
// K11, one warp a ray. Lane j takes sample base + j, 32 samples a round,
// their loads in flight together; a ballot of "inside and occupied" and its
// lowest set bit give the first hit in sample order, and the warp stops
// after the round that holds it. A ray that misses 1024 samples waits on 32
// round trips, not 1024; neighbouring samples share words, so a round's
// reads coalesce; a chunk of 8192 rays is 8192 warps, about one resident
// wave of the card. (Two rounds in flight bought nothing, PERF.md §6.)
//
// K10, one thread a ray (the march is a float32 recurrence, bit for bit
// the plain version's, so it cannot be split). A ray computes BATCH steps'
// cells ahead, issues the reads they need together, then tests them in
// order; first_only stops after the batch that holds the first hit, and
// every output is the logical march's (a read issued past the ray's end is
// never tested). From level MASK_FROM up, where the grid (16 MiB and more)
// no longer stays in L2, a coarse mask also skips reads: one bit a B^3
// block of cells, the OR of its cells, B = 2^(level - MASK_LEVEL) (2^18
// bits, 32 KB), staged in shared memory by every block; a step reads its
// word only where its block is occupied. The mask is built by a pre-pass
// (coarse_kernel) in every call, on the same stream, so a captured frame or
// a grid rewritten in place never meets a stale one. Below MASK_FROM the
// mask does not pay: a warp waits on a batch's reads whenever one of its 32
// rays needs one, which is nearly every batch, so skipping saves no round
// trip and costs instructions (PERF.md §6). Blocks shrink to as few as 32
// threads where the rays are few, so that a chunk spreads over the SMs.
//
// The results equal the plain versions bit for bit. So the arithmetic is
// theirs, operation for operation, in float32 with round-to-nearest, and
// written with __fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise
// contract a * b + c into one FMA (rounded once), and a tie at a cell
// boundary would go the other way. Division stays IEEE (nvcc's default
// -prec-div=true).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e10f;  // ops/ray_voxel.py's _INF
// K10's coarse mask is a level-MASK_LEVEL grid: 2^18 bits, MASK_WORDS words;
// K10 marches through it from level MASK_FROM up
constexpr int MASK_LEVEL = 6;
constexpr int MASK_WORDS = 1 << (3 * MASK_LEVEL - 5);
constexpr int MASK_FROM = 9;
static_assert(MASK_LEVEL >= 5, "a mask word is 32 blocks of one z-run");
static_assert(MASK_FROM > MASK_LEVEL, "the mask's blocks hold more than a cell");
// K10's steps computed ahead of their reads
constexpr int BATCH = 8;

__device__ __forceinline__ bool occupied(const unsigned* __restrict__ occ, long long idx) {
  return (__ldg(occ + (idx >> 5)) >> (idx & 31)) & 1u;
}

__device__ __forceinline__ float clamp_cell(float x, int n) {
  return fminf(fmaxf(floorf(x), 0.0f), (float)(n - 1));
}

// K10's and K12's pre-pass, above MASK_LEVEL: bit c of the mask is the OR
// of the B^3 cells of block c (B = 2^s, s = level - MASK_LEVEL), blocks in
// the linear (x, y, z) order of a level-MASK_LEVEL grid. One warp a mask
// word: its 32 blocks run along z, so its cells are B words of each of B^2
// rows, B^3 words that the lanes read side by side (a row's B words are
// adjacent), each ORed into the bits of the blocks it covers; one store a
// word, so nothing is zeroed first and nothing is atomic. The grid's words
// lie STRIDE words apart: 1 for K10's bitfield, 2 for K12's meta rows
// (coarse word, rank), whose coarse words are a level-(L - 3) bitfield.
template <int STRIDE>
__global__ void __launch_bounds__(THREADS)
coarse_kernel(const unsigned* __restrict__ occ, int level, unsigned* __restrict__ mask) {
  constexpr int UNROLL = 8;
  const int word = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (word >= MASK_WORDS) return;
  const int s = level - MASK_LEVEL;
  const long long b = 1LL << s;
  const long long bx = word >> (2 * MASK_LEVEL - 5);
  const long long by = (word >> (MASK_LEVEL - 5)) & ((1 << MASK_LEVEL) - 1);
  const long long bz0 = (long long)(word & ((1 << (MASK_LEVEL - 5)) - 1)) << 5;
  const long long row_words = 1LL << (level - 5);  // the words of one (x, y) row
  const long long z_word = (bz0 << s) >> 5;        // the run's first word in its row
  const long long n = b * b * b;
  unsigned acc = 0;
  for (long long j0 = lane; j0 < n; j0 += 32 * UNROLL) {
    unsigned w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = j0 + 32 * u, row = j >> s;
      const long long x = (bx << s) + (row >> s), y = (by << s) + (row & (b - 1));
      w[u] = j < n ? __ldg(occ + STRIDE * (((x << level) + y) * row_words + z_word + (j & (b - 1))))
                   : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!w[u]) continue;
      const int k = (int)((j0 + 32 * u) & (b - 1));  // the word's place in its row's run
      if (s >= 5) {  // the word lies inside one block
        acc |= 1u << (k >> (s - 5));
      } else {  // the word covers 32 / B blocks, B bits each
        const unsigned m = (1u << (1 << s)) - 1u;
        for (int g = 0; g < (32 >> s); ++g)
          if ((w[u] >> (g << s)) & m) acc |= 1u << ((k << (5 - s)) + g);
      }
    }
  }
  acc = __reduce_or_sync(0xffffffffu, acc);
  if (lane == 0) mask[word] = acc;
}

template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
dda_kernel(const unsigned* __restrict__ occ, const unsigned* __restrict__ mask, int level,
           const float* __restrict__ rays_o, const float* __restrict__ rays_d, long long n_rays,
           int first_only, int max_steps, float* __restrict__ t_first,
           float* __restrict__ t_last, unsigned char* __restrict__ hit,
           int* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned smask[];
  const int shift = level - MASK_LEVEL;  // log2 of a mask block's edge (MASKED)
  if (MASKED) {
    for (int k = threadIdx.x; k < MASK_WORDS / 4; k += blockDim.x)
      nw::cp_async16(smask + 4 * k, mask + 4 * k);
    nw::cp_async_commit();
    nw::cp_async_wait<0>();
    __syncthreads();
  }
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int n = 1 << level;
  const float cell_w = 2.0f / (float)n;
  // per axis; indexed by constants only (the step's axis is applied by
  // selects), so that all of it stays in registers
  float o[3], d[3], inv[3], tmax[3], tdelta[3];
  int cell[3], dir[3];
  float t_enter = -INFINITY, t_exit = INFINITY;
#pragma unroll
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
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(o[a], __fmul_rn(d[a], t_in));
    cell[a] = (int)clamp_cell(__fadd_rn(pos, 1.0f) / cell_w, n);
    const bool up = d[a] > 0.0f;
    const float bound = __fsub_rn(__fmul_rn((float)(cell[a] + (up ? 1 : 0)), cell_w), 1.0f);
    tmax[a] = __fmul_rn(__fsub_rn(bound, o[a]), inv[a]);
    tdelta[a] = __fmul_rn(cell_w, fabsf(inv[a]));
    dir[a] = up ? 1 : -1;
  }
  float t_cur = t_enter, first = BIG, last = -BIG;
  int i = 0;
  bool go = active && max_steps > 0;
  while (go) {
    // the next BATCH steps of the march: their entry t, their cell, and
    // whether they read it (0 past the ray's end, 1 an empty mask block, 2
    // read the word)
    float ts[BATCH];
    long long at[BATCH];
    unsigned char kind[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      kind[j] = 0;
      if (active && i + j < max_steps) {
        ts[j] = t_cur;
        bool read = true;
        if (MASKED) {
          const int c = ((cell[0] >> shift) << (2 * MASK_LEVEL)) |
                        ((cell[1] >> shift) << MASK_LEVEL) | (cell[2] >> shift);
          read = (smask[c >> 5] >> (c & 31)) & 1u;
        }
        kind[j] = read ? 2 : 1;
        at[j] = ((((long long)cell[0] << level) | cell[1]) << level) | cell[2];
        // argmin, the first axis on ties
        const bool y = tmax[1] < tmax[0];
        const float t_xy = y ? tmax[1] : tmax[0];
        const bool z = tmax[2] < t_xy;
        const int a = z ? 2 : (y ? 1 : 0);
        const float t_next = z ? tmax[2] : t_xy;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (q == a) {
            tmax[q] = __fadd_rn(tmax[q], tdelta[q]);
            cell[q] += dir[q];
          }
        }
        // the ray leaves the grid where the stepped axis leaves [0, n): the
        // plain version's count of steps left on that axis going below 0
        active = (unsigned)(z ? cell[2] : (y ? cell[1] : cell[0])) < (unsigned)n &&
                 t_next <= t_exit;
        t_cur = t_next;
      }
    }
    unsigned w[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) w[j] = kind[j] == 2 ? __ldg(occ + (at[j] >> 5)) : 0u;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (kind[j] && go) {
        ++i;
        if (kind[j] == 2 && ((w[j] >> (at[j] & 31)) & 1u)) {
          if (first >= BIG) first = ts[j];
          last = ts[j];
          if (first_only) go = false;
        }
      }
    }
    go = go && active && i < max_steps;
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
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;  // a warp's ray
  const int lane = threadIdx.x & 31;
  if (r >= n_rays) return;
  const int n = 1 << level;
  const float half_n = (float)n / 2.0f;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = __ldg(rays_o + 3 * r + a);
    d[a] = __ldg(rays_d + 3 * r + a);
  }
  const float lo = __ldg(t_lo + r);
  const float span = __fsub_rn(__ldg(t_hi + r), lo);
  float found = 0.0f;
  bool h = false;
  int walked = n_samples;
  for (int base = 0; base < n_samples; base += 32) {
    const int k = base + lane;
    float t = 0.0f;
    bool occ_k = false;
    if (k < n_samples) {
      t = __fadd_rn(lo, __fmul_rn(span, __ldg(rel + k)));
      bool inside = true;
      long long idx = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float p = __fadd_rn(o[a], __fmul_rn(d[a], t));
        inside = inside && fabsf(p) < 1.0f;
        idx = idx * n + (long long)clamp_cell(__fmul_rn(__fadd_rn(p, 1.0f), half_n), n);
      }
      occ_k = inside && occupied(occ, idx);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, occ_k);
    if (hits) {  // the lowest lane is the first sample
      const int j = __ffs(hits) - 1;
      found = __shfl_sync(0xffffffffu, t, j);
      h = true;
      walked = base + j + 1;
      break;
    }
  }
  if (lane == 0) {
    t_first[r] = found;
    hit[r] = h;
    if (steps_out) steps_out[r] = walked;
  }
}

// K12. The grid is two levels (ops/ray_voxel.py's HierGrid): meta holds, per
// 32 blocks of 8^3 cells along z, the coarse occupancy word and the rank of
// its first block among the occupied ones; fine holds 16 words (512 bits)
// per occupied block, in rank order. A step probes the point eps past the
// current entry, takes its fine cell and block, and advances to the exit of
// the fine cell inside an occupied block and of the whole block through an
// empty one, the exit recomputed from the cell at that granularity (no
// incremental tmax), as JAX's dda_traverse_hier does; a step inside an
// occupied block tests the cell's fine bit.
//
// What bounds it. A step is ~40 dependent float operations and one or two
// reads: the meta row, then in an occupied block the fine word at slot
// rank + popc(word & ((1 << bit) - 1)); the next step's granularity waits
// on the meta bit. At the filter's level 12 meta is 32 MiB and a ray of
// the filter's views takes ~650 steps, ~96 % of them across empty blocks.
// The parent's step made an IEEE division that the compiler rebuilt in
// every step from w_g = occupied ? w_f : w_c, and nine float <-> int
// conversions, which issue at an eighth of the FP32 rate. So:
//  - a step of FP32 adds, multiplies and fmas (below), its constants built
//    from exponent bits: a step across an empty mask block is 63 SASS
//    instructions;
//  - a coarse mask: from level HIER_MASK_FROM up K10's pre-pass
//    (coarse_kernel, reading meta's coarse words, in every call, on the
//    same stream) ORs the blocks into a level-MASK_LEVEL grid of 2^18 bits
//    (32 KB), which every block stages in shared memory; a step inside an
//    empty mask block reads nothing from device memory (~47 reads are left
//    of a level-12 ray's ~620 steps);
//  - one read per occupied block: entering one, the ray reads its meta row
//    and its 16 fine words (64 bytes, four 16-byte loads issued together)
//    into shared memory, and its fine steps test bits there; the block's
//    exit is computed before its occupancy is known, off the lookup's
//    chain.
// Now a march is bound by latency more than by issue (PERF.md section 7):
// each step's chain of dependent FP32 operations and shared-memory mask
// read, and, in most of a warp's steps, some lane's read from device memory,
// which holds the other 31; at 76,800 rays (4 views) a scheduler holds
// ~4.5 warps, too few to hide them.
// Left out, each slower on the card (PERF.md section 6): a batch of steps
// computed ahead so that their rows are read together (the probes are one
// serial float chain that a batch cannot shorten, the mask leaves few reads
// to overlap, and a batch's state costs instructions on every step: +16 %
// at one step a batch against this step, more at 4 and up), a kept meta
// row, one fine word a step, cubes of 8^3 blocks whose bits a pre-pass lays
// out contiguously, lanes that take a new ray as soon as theirs ends, and a
// step without branches (predicated reads).
// Blocks shrink to as few as 32 threads where the rays are few, as K10's.
// The arithmetic gives dda_traverse_hier_plain's values exactly (see above
// for the _rn spelling); eps = eps_c / max|d| is an IEEE division, as the
// plain version's tensor division is.
// K12 marches through the coarse mask from this level up: the lowest whose
// blocks outnumber the mask's bits, and never slower there than without it
constexpr int HIER_MASK_FROM = 10;
static_assert(HIER_MASK_FROM - 3 > MASK_LEVEL, "the mask's blocks hold more than a block");

// A step's arithmetic, written so that almost all of it issues as FP32 add,
// multiply and fma, the only operations the SM issues at its full rate
// (integer, shift, logic, compare, min / max: half; conversions between
// float and int: an eighth). Each form gives the plain version's values
// exactly:
//  - the probe's (p + 1) / w_f is (p + 1) 2^(L-1), and scaling by a power
//    of two commutes with rounding, so it is fma(p, 2^(L-1), 2^(L-1));
//    clamped to [0, 2^L] it is sat(fma(p, 1/2, 1/2)) 2^L (NaN goes to 0, as
//    the plain clamp of a NaN floor does);
//  - floor of a clamped y: y + 2^23 rounded down is 2^23 + floor(y) for y
//    in [0, 2^23), its float kept as the cell (bits 0x4B000000 + cell);
//  - the cell's block, 2^23 + floor(cell / 8), is that float / 8 (exact)
//    plus 2^23 - 2^20 rounded down: one fma;
//  - (g + up) w_g - 1 rounds once, since (g + up) w_g is exact: one fma.
constexpr float TWO23 = 8388608.0f;
constexpr int TWO23_BITS = 0x4B000000;

// 2^23 + the fine cell of the probe at t on one axis (scale_l = 2^L)
__device__ __forceinline__ float hier_cell(float o, float d, float t, float scale_l,
                                           float top) {
  const float p = __fadd_rn(o, __fmul_rn(d, t));
  const float y = fminf(__fmul_rn(__saturatef(__fmaf_rn(p, 0.5f, 0.5f)), scale_l), top);
  return __fadd_rd(y, TWO23);
}

// the exit t on one axis of the cell whose 2^23 + index is g (upm: up - 2^23)
__device__ __forceinline__ float hier_exit(float g, float upm, float w_g, float o, float inv) {
  const float hi = __fmaf_rn(__fadd_rn(g, upm), w_g, -1.0f);
  return __fmul_rn(__fsub_rn(hi, o), inv);
}

// 2^23 + the block of a fine cell given as 2^23 + index
__device__ __forceinline__ float hier_block_of(float rc) {
  return __fmaf_rd(rc, 0.125f, TWO23 - 1048576.0f);
}

// the mask bit of the mask block holding a cell given as 2^23 + index per
// axis (mshift = 2^(MASK_LEVEL - L), mbase = 2^23 - 2^(23 + MASK_LEVEL - L)):
// its coordinates found as hier_block_of finds a block, its index m as the
// float 2^23 + m, by fmas (the values are integers below 2^24, so exact)
__device__ __forceinline__ bool hier_mask_bit(const unsigned* smask, const float* rc,
                                              float mshift, float mbase) {
  const float mx = __fmaf_rd(rc[0], mshift, mbase) - TWO23;
  const float my = __fmaf_rd(rc[1], mshift, mbase) - TWO23;
  const int m = __float_as_int(
      __fmaf_rn(mx, (float)(1 << (2 * MASK_LEVEL)),
                __fmaf_rn(my, (float)(1 << MASK_LEVEL), __fmaf_rd(rc[2], mshift, mbase))));
  return (smask[(m - TWO23_BITS) >> 5] >> (m & 31)) & 1u;
}

// fine word k of the block at slot, the plain version's clamp included: a
// slot outside fine (a rank past its end, or a negative one) reads its last
// (first) word
__device__ __forceinline__ long long hier_at(long long slot, int k, long long n_fine) {
  const long long at = slot * 16 + k;
  return at < 0 ? 0 : (at >= n_fine ? n_fine - 1 : at);
}

// the 16 fine words of the block at slot into this thread's column of
// shared memory (word k at mine[k * stride]); fine is 16-byte aligned
__device__ __forceinline__ void hier_block_words(const unsigned* __restrict__ fine,
                                                 long long n_fine, long long slot,
                                                 unsigned* mine, int stride) {
  if (slot >= 0 && slot * 16 < n_fine) {  // n_fine is a multiple of 16
    const uint4* src = reinterpret_cast<const uint4*>(fine + slot * 16);
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(src + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mine[(4 * k) * stride] = q[k].x;
      mine[(4 * k + 1) * stride] = q[k].y;
      mine[(4 * k + 2) * stride] = q[k].z;
      mine[(4 * k + 3) * stride] = q[k].w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) mine[k * stride] = __ldg(fine + hier_at(slot, k, n_fine));
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
dda_hier_kernel(const uint2* __restrict__ meta, const unsigned* __restrict__ mask,
                const unsigned* __restrict__ fine, long long n_fine, int level,
                const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                long long n_rays, int first_only, int max_steps, float eps_c,
                float* __restrict__ t_first, float* __restrict__ t_last,
                unsigned char* __restrict__ hit, int* __restrict__ steps_out) {
  __shared__ __align__(16) unsigned smask[MASKED ? MASK_WORDS : 4];  // the coarse mask
  // the held block's 16 fine words, one column a thread: word k of thread t
  // at k * blockDim.x + t, conflict-free
  extern __shared__ unsigned sheld[];
  if (MASKED) {
    for (int k = threadIdx.x; k < MASK_WORDS / 4; k += blockDim.x)
      nw::cp_async16(smask + 4 * k, mask + 4 * k);
    nw::cp_async_commit();
    nw::cp_async_wait<0>();
    __syncthreads();
  }
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  unsigned* mine = sheld + threadIdx.x;
  const int stride = blockDim.x;
  // a cell's mask block, 2^23 + cell / 2^(L - MASK_LEVEL) rounded down (MASKED)
  const float mshift = __int_as_float((127 + MASK_LEVEL - level) << 23);
  const float mbase = TWO23 - __int_as_float((150 + MASK_LEVEL - level) << 23);
  const int n_c = 1 << (level - 3);
  // 2 / n_f, 2 / n_c and n_f from their exponents: powers of two, and no
  // division that the compiler could recompute in every step
  const float w_f = __int_as_float((128 - level) << 23);
  const float w_c = __int_as_float((131 - level) << 23);
  const float scale_l = __int_as_float((127 + level) << 23);
  const float top = scale_l - 1.0f;  // the last cell
  float o[3], d[3], inv[3], upm[3];
  float t_enter = -INFINITY, t_leave = INFINITY, dmax = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
    if (fabsf(d[a]) < 1e-12f) d[a] = 1e-12f;
    inv[a] = 1.0f / d[a];
    upm[a] = d[a] > 0.0f ? 1.0f - TWO23 : -TWO23;
    const float t0 = __fmul_rn(__fsub_rn(-1.0f, o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(1.0f, o[a]), inv[a]);
    t_enter = fmaxf(t_enter, fminf(t0, t1));
    t_leave = fminf(t_leave, fmaxf(t0, t1));
    dmax = fmaxf(dmax, fabsf(d[a]));
  }
  t_enter = fmaxf(t_enter, 0.0f);
  const float eps = eps_c / dmax;
  float t_cur = t_enter, first = BIG, last = -BIG;
  int i = 0;
  bool go = t_leave > t_enter && max_steps > 0, found = false;
  // the occupied block whose fine words mine holds, as the bits of 2^23 +
  // its coordinates, and its slot in fine
  int hx = -1, hy = 0, hz = 0;
  long long slot = 0;
  while (go) {
    const float tt = __fadd_rn(t_cur, eps);
    float rc[3], rb[3];  // 2^23 + the probe's fine cell, and its block, per axis
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rc[a] = hier_cell(o[a], d[a], tt, scale_l, top);
      rb[a] = hier_block_of(rc[a]);
    }
    // the block's exit, computed before the block is known to be empty
    float t_next = fminf(fminf(hier_exit(rb[0], upm[0], w_c, o[0], inv[0]),
                               hier_exit(rb[1], upm[1], w_c, o[1], inv[1])),
                         hier_exit(rb[2], upm[2], w_c, o[2], inv[2]));
    const bool rd = !MASKED || hier_mask_bit(smask, rc, mshift, mbase);
    if (rd) {
      const int bx = __float_as_int(rb[0]), by = __float_as_int(rb[1]),
                bz = __float_as_int(rb[2]);
      bool blk = bx == hx && by == hy && bz == hz;
      if (!blk) {
        const long long b = ((long long)(bx - TWO23_BITS) * n_c + (by - TWO23_BITS)) * n_c +
                            (bz - TWO23_BITS);
        const uint2 row = __ldg(meta + (b >> 5));
        const unsigned bit = (unsigned)(b & 31);
        if ((row.x >> bit) & 1u) {
          blk = true;
          hx = bx, hy = by, hz = bz;
          slot = (long long)(int)row.y + __popc(row.x & ((1u << bit) - 1u));
          hier_block_words(fine, n_fine, slot, mine, stride);
        }
      }
      if (blk) {  // a fine step: its cell's bit, its exit
        const int fidx = (((__float_as_int(rc[0]) & 7) * 8 + (__float_as_int(rc[1]) & 7)) * 8) +
                         (__float_as_int(rc[2]) & 7);
        if ((mine[(fidx >> 5) * stride] >> (fidx & 31)) & 1u) {
          if (first >= BIG) first = t_cur;
          last = t_cur;
          found = first_only;
        }
        t_next = fminf(fminf(hier_exit(rc[0], upm[0], w_f, o[0], inv[0]),
                             hier_exit(rc[1], upm[1], w_f, o[1], inv[1])),
                       hier_exit(rc[2], upm[2], w_f, o[2], inv[2]));
      }
    }
    t_cur = fmaxf(t_next, tt);  // at least eps of progress
    ++i;
    go = !found && t_cur < t_leave && i < max_steps;
  }
  const bool h = first < BIG;
  t_first[r] = h ? first : 0.0f;
  t_last[r] = h ? last : 0.0f;
  hit[r] = h;
  if (steps_out) steps_out[r] = i;
}

}  // namespace

template <int STRIDE>
static int launch_coarse(const void* occ, int level, void* mask, cudaStream_t stream) {
  coarse_kernel<STRIDE><<<MASK_WORDS * 32 / THREADS, THREADS, 0, stream>>>(
      static_cast<const unsigned*>(occ), level, static_cast<unsigned*>(mask));
  return (int)cudaGetLastError();
}

// K10's coarse mask of a level-`level` grid (level > MASK_LEVEL) into mask,
// MASK_WORDS words (16-byte aligned): the pre-pass nw_dda runs, alone.
extern "C" int nw_coarse_mask(const void* occ, int level, void* mask, void* stream) {
  if (level <= MASK_LEVEL || level > 20 || !mask || (reinterpret_cast<uintptr_t>(mask) & 15))
    return -1;
  return launch_coarse<1>(occ, level, mask, static_cast<cudaStream_t>(stream));
}

// (t_first, t_last, hit) of rays (R, 3) + (R, 3) float32 in grid-normalised
// coordinates through the level-`level` bitfield; mask: MASK_WORDS words of
// 16-byte aligned scratch, which the pre-pass writes first from level
// MASK_FROM up (else unused); steps_out (R,) int32 or null: the loop trips
// of each ray.
extern "C" int nw_dda(const void* occ, void* mask, int level, const float* rays_o,
                      const float* rays_d, long long n_rays, int first_only, int max_steps,
                      float* t_first, float* t_last, unsigned char* hit, int* steps_out,
                      void* stream) {
  const bool masked = level >= MASK_FROM;
  if (level < 0 || level > 20 || max_steps < 0 ||
      (masked && (!mask || (reinterpret_cast<uintptr_t>(mask) & 15))))
    return -1;
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked) {
    const int err = launch_coarse<1>(occ, level, mask, s);
    if (err) return err;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  // halve the block (down to a warp) until there are four blocks an SM
  int threads = THREADS;
  while (threads > 32 && (n_rays + threads - 1) / threads < 4LL * sms) threads >>= 1;
  const long long blocks = (n_rays + threads - 1) / threads;
  auto kernel = masked ? dda_kernel<true> : dda_kernel<false>;
  kernel<<<(unsigned)blocks, threads, masked ? MASK_WORDS * sizeof(unsigned) : 0, s>>>(
      static_cast<const unsigned*>(occ), static_cast<const unsigned*>(mask), level, rays_o,
      rays_d, n_rays, first_only, max_steps, t_first, t_last, hit, steps_out);
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
  const long long blocks = (n_rays * 32 + THREADS - 1) / THREADS;
  sampled_hit_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(occ), level, rays_o, rays_d, t_lo, t_hi, rel, n_samples,
      n_rays, t_first, hit, steps_out);
  return (int)cudaGetLastError();
}

// K12's coarse mask of a level-`level` two-level grid (level - 3 >
// MASK_LEVEL) into mask, MASK_WORDS words (16-byte aligned): the pre-pass
// nw_dda_hier runs from HIER_MASK_FROM up, alone.
extern "C" int nw_hier_mask(const void* meta, int level, void* mask, void* stream) {
  if (level - 3 <= MASK_LEVEL || level > 20 || !mask || (reinterpret_cast<uintptr_t>(mask) & 15))
    return -1;
  return launch_coarse<2>(meta, level - 3, mask, static_cast<cudaStream_t>(stream));
}

// K12: (t_first, t_last, hit) of rays through the two-level grid of a
// level-`level` occupancy (meta: (2^{3(level-3)} / 32, 2) words, fine:
// n_fine words, a multiple of 16, 16-byte aligned); mask: MASK_WORDS words
// of 16-byte aligned scratch, which the pre-pass writes first from level
// HIER_MASK_FROM up (else unused); eps_c = 2^{1-level} * 1e-3 as float32;
// steps_out (R,) int32 or null: the steps of each ray.
extern "C" int nw_dda_hier(const void* meta, void* mask, const void* fine, long long n_fine,
                           int level, const float* rays_o, const float* rays_d, long long n_rays,
                           int first_only, int max_steps, float eps_c, float* t_first,
                           float* t_last, unsigned char* hit, int* steps_out, void* stream) {
  const bool masked = level >= HIER_MASK_FROM;
  if (level < 3 || level > 20 || max_steps < 0 || n_fine < 16 || (n_fine & 15) ||
      (reinterpret_cast<uintptr_t>(fine) & 15) ||
      (masked && (!mask || (reinterpret_cast<uintptr_t>(mask) & 15))))
    return -1;
  if (n_rays <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked) {
    const int err = launch_coarse<2>(meta, level - 3, mask, s);
    if (err) return err;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  // halve the block (down to a warp) until there are four blocks an SM
  int threads = THREADS;
  while (threads > 32 && (n_rays + threads - 1) / threads < 4LL * sms) threads >>= 1;
  const long long blocks = (n_rays + threads - 1) / threads;
  // 32 KB of mask (static) and at most 16 KB of held words: within the default 48 KB
  const size_t smem = 16 * threads * sizeof(unsigned);
  auto kernel = masked ? dda_hier_kernel<true> : dda_hier_kernel<false>;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const uint2*>(meta), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(fine), n_fine, level, rays_o, rays_d, n_rays, first_only,
      max_steps, eps_c, t_first, t_last, hit, steps_out);
  return (int)cudaGetLastError();
}
