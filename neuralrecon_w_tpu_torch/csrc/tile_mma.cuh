// Device helpers shared by the SDF kernels (sdf_mlp.cu, sdf_vjp.cu): the
// softplus(beta 100, threshold 20) of the SDF MLP, the bf16 tensor-core
// fragments (ldmatrix from shared memory, plain or transposed, mma.sync
// m16n8k16 with f32 accumulation), the split-TF32 product of f32 operands
// (mma.sync m16n8k8 on hi / lo halves), and cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nw {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float softplus100(float z) {
  const float zb = z * 100.0f;
  return zb > 20.0f ? z : log1pf(expf(fminf(zb, 20.0f))) / 100.0f;
}

// softplus100 with the fast exp / log intrinsics and a product for the
// division: within ~1e-7 of it (the epilogue of K1, which would otherwise
// spend as long on softplus as on its products)
__device__ __forceinline__ float softplus100_fast(float z) {
  const float zb = z * 100.0f;
  return zb > 20.0f ? z : __logf(1.0f + __expf(fminf(zb, 20.0f))) * 0.01f;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the four 8 x 8 matrices transposed: lane t receives column t / 4, rows
// 2 (t % 4) and 2 (t % 4) + 1 of each, so a point-major tile (rows = k)
// feeds the k-pairs mma.sync wants
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to the nearest TF32 (the low 13 mantissa bits cleared)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value; hi + lo differs from x by <= 2^-22 |x|
__device__ __forceinline__ void tf32_split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for f32 a, b given as TF32 (hi, lo) halves: the three products
// that carry f32 accuracy, small ones first (a_lo b_lo, ~2^-22 of the
// product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float* c, const unsigned* a_hi, const unsigned* a_lo,
                                           unsigned b_hi0, unsigned b_hi1, unsigned b_lo0,
                                           unsigned b_lo1) {
  mma_tf32(c, a_lo, b_hi0, b_hi1);
  mma_tf32(c, a_hi, b_lo0, b_lo1);
  mma_tf32(c, a_hi, b_hi0, b_hi1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace nw
