// Device helpers shared by the SDF kernels (sdf_mlp.cu, sdf_vjp.cu): the
// softplus(beta 100, threshold 20) of the SDF MLP, and the bf16 tensor-core
// fragments (ldmatrix from shared memory, mma.sync m16n8k16 with f32
// accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nw {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float softplus100(float z) {
  const float zb = z * 100.0f;
  return zb > 20.0f ? z : log1pf(expf(fminf(zb, 20.0f))) / 100.0f;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

}  // namespace nw
