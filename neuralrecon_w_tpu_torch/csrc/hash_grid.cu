// K13 / K14: the multi-resolution hash encoding (Instant-NGP, as Neuralangelo
// configures it) and its table gradient (neuralrecon_w_tpu_torch/ops/hash_grid.py,
// whose plain versions these equal to rounding).
//
// One thread a (point, level); consecutive threads take consecutive levels of
// one point, so a warp writes (or reads) two points' whole encodings, 32
// bytes a thread, in one coalesced transaction each. A level's entry is 8
// float32 features, 32 bytes: read as two float4 loads through the read-only
// path, the eight corners' loads issued before the blend. Levels at or past
// the active count (an int32 read from device memory, so a CUDA graph serves
// every stage of the coarse-to-fine schedule) write zeros and add no
// gradient. K14 adds each corner's weighted gradient with float4 atomics
// (sm_90, CUDA 12.1 on) or four float atomics.
//
// The position arithmetic is written with __fadd_rn / __fmul_rn / __fsub_rn
// so that nvcc contracts nothing into an FMA: u = (x + B) * (N / 2B), the
// cell c0 = min(floor(u), N - 1), t = u - c0, and a corner's weight
// (wx * wy) * wz, as the plain version computes them.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int HASH_MAX_LEVELS = 32;
constexpr int HASH_THREADS = 256;

struct HashLevels {
  int res[HASH_MAX_LEVELS];
  float scale[HASH_MAX_LEVELS];
  long long offset[HASH_MAX_LEVELS];
  int dense[HASH_MAX_LEVELS];
  int levels;
  int table_mask;
  float bound;
};

struct Corners {
  long long row[8];
  float w[8];
};

__device__ __forceinline__ void corners(const float* __restrict__ x, long long p, int l,
                                        const HashLevels& lv, Corners& c) {
  const int n = lv.res[l];
  const float s = lv.scale[l];
  int c0[3];
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float v = fminf(fmaxf(x[3 * p + a], -lv.bound), lv.bound);
    float u = __fmul_rn(__fadd_rn(v, lv.bound), s);
    float f = fminf(floorf(u), (float)(n - 1));
    c0[a] = (int)f;
    t[a] = __fsub_rn(u, f);
  }
  const long long base = lv.offset[l];
  const bool dense = lv.dense[l] != 0;
  const long long n1 = n + 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int bx = (k >> 2) & 1, by = (k >> 1) & 1, bz = k & 1;
    const int cx = c0[0] + bx, cy = c0[1] + by, cz = c0[2] + bz;
    const float wx = bx ? t[0] : __fsub_rn(1.0f, t[0]);
    const float wy = by ? t[1] : __fsub_rn(1.0f, t[1]);
    const float wz = bz ? t[2] : __fsub_rn(1.0f, t[2]);
    c.w[k] = __fmul_rn(__fmul_rn(wx, wy), wz);
    long long idx;
    if (dense) {
      idx = (long long)cx + (long long)cy * n1 + (long long)cz * n1 * n1;
    } else {
      const uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^
                         ((uint32_t)cz * 805459861u);
      idx = (long long)(h & (uint32_t)lv.table_mask);
    }
    c.row[k] = base + idx;
  }
}

__global__ void __launch_bounds__(HASH_THREADS)
    hash_encode_kernel(const float* __restrict__ x, long long n_pts,
                       const float4* __restrict__ table, const int* __restrict__ active,
                       HashLevels lv, float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * HASH_THREADS + threadIdx.x;
  if (i >= n_pts * lv.levels) return;
  const long long p = i / lv.levels;
  const int l = (int)(i - p * lv.levels);
  float4* dst = out + 2 * i;
  if (l >= __ldg(active)) {
    dst[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  Corners c;
  corners(x, p, l, lv, c);
  float4 e[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    e[k][0] = __ldg(table + 2 * c.row[k]);
    e[k][1] = __ldg(table + 2 * c.row[k] + 1);
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = c.w[k];
    a.x = fmaf(w, e[k][0].x, a.x);
    a.y = fmaf(w, e[k][0].y, a.y);
    a.z = fmaf(w, e[k][0].z, a.z);
    a.w = fmaf(w, e[k][0].w, a.w);
    b.x = fmaf(w, e[k][1].x, b.x);
    b.y = fmaf(w, e[k][1].y, b.y);
    b.z = fmaf(w, e[k][1].z, b.z);
    b.w = fmaf(w, e[k][1].w, b.w);
  }
  dst[0] = a;
  dst[1] = b;
}

__device__ __forceinline__ void add4(float4* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, v);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d + 0, v.x);
  atomicAdd(d + 1, v.y);
  atomicAdd(d + 2, v.z);
  atomicAdd(d + 3, v.w);
#endif
}

__global__ void __launch_bounds__(HASH_THREADS)
    hash_grad_kernel(const float* __restrict__ x, long long n_pts,
                     const float4* __restrict__ grad_out, const int* __restrict__ active,
                     HashLevels lv, float4* __restrict__ grad_table) {
  const long long i = (long long)blockIdx.x * HASH_THREADS + threadIdx.x;
  if (i >= n_pts * lv.levels) return;
  const long long p = i / lv.levels;
  const int l = (int)(i - p * lv.levels);
  if (l >= __ldg(active)) return;
  const float4 ga = __ldg(grad_out + 2 * i), gb = __ldg(grad_out + 2 * i + 1);
  Corners c;
  corners(x, p, l, lv, c);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = c.w[k];
    add4(grad_table + 2 * c.row[k], make_float4(w * ga.x, w * ga.y, w * ga.z, w * ga.w));
    add4(grad_table + 2 * c.row[k] + 1, make_float4(w * gb.x, w * gb.y, w * gb.z, w * gb.w));
  }
}

static bool levels_ok(const HashLevels* lv) {
  return lv != nullptr && lv->levels >= 1 && lv->levels <= HASH_MAX_LEVELS;
}

// Each entry returns a cudaError_t value (0 = launched), or -1 for arguments
// the kernel does not take.
extern "C" int nw_hash_encode(const void* x, long long n_pts, const void* table,
                              const void* active, const HashLevels* lv, void* out,
                              void* stream) {
  if (x == nullptr || table == nullptr || active == nullptr || out == nullptr || n_pts < 0 ||
      !levels_ok(lv))
    return -1;
  const long long threads = n_pts * lv->levels;
  if (threads == 0) return 0;
  const long long blocks = (threads + HASH_THREADS - 1) / HASH_THREADS;
  hash_encode_kernel<<<(unsigned)blocks, HASH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_pts, static_cast<const float4*>(table),
      static_cast<const int*>(active), *lv, static_cast<float4*>(out));
  return (int)cudaGetLastError();
}

extern "C" int nw_hash_grad(const void* x, long long n_pts, const void* grad_out,
                            const void* active, const HashLevels* lv, void* grad_table,
                            void* stream) {
  if (x == nullptr || grad_out == nullptr || active == nullptr || grad_table == nullptr ||
      n_pts < 0 || !levels_ok(lv))
    return -1;
  const long long threads = n_pts * lv->levels;
  if (threads == 0) return 0;
  const long long blocks = (threads + HASH_THREADS - 1) / HASH_THREADS;
  hash_grad_kernel<<<(unsigned)blocks, HASH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_pts, static_cast<const float4*>(grad_out),
      static_cast<const int*>(active), *lv, static_cast<float4*>(grad_table));
  return (int)cudaGetLastError();
}
