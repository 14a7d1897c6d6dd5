// K15: the split-TF32 GEMM, float32-accurate products on Hopper's tensor
// cores (neuralrecon_w_tpu_torch/ops/split_tf32.py, whose plain version it
// equals to float32 rounding).
//
// It replaces no Pallas kernel: it runs the field's float32 products, the
// ones models/layers._product issues (the JAX package leaves them to XLA,
// neuralrecon_w_tpu/ops/field_vjp_math.py:114), forward, input gradient and
// weight gradient, so also the double backward, which is made of them.
//
// Bound: operations. float32 on the FMA pipes peaks at ~67 TFLOP/s; the
// TF32 tensor cores at 495. Each float32 operand is split into two TF32
// values, x = hi + lo (cvt.rna, |x - hi - lo| <= 2^-22 |x|), and
// c += a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first; a_lo b_lo,
// ~2^-22 of the product, is dropped): three TF32 products a float32 one,
// 165 TFLOP/s of float32-accurate work (chip_smoke.bound's f32 rate).
//
// C[m, n] = sum_k A'[m, k] B'[n, k] in three forms of row-major operands:
//   'nt'  A' = A (M, K), B' = B (N, K)       y = x w^T (+ bias)
//   'nn'  A' = A (M, K), B' = B^T, B (K, N)  dx = dy w
//   'tn'  A' = A^T, A (K, M), B' = B^T       dw = dy^T x, split over K
// A block (one an SM, persistent) takes 128 x BN tiles of C in turn (BN 8
// to 136 in 8s, chosen from the width): two consumer warpgroups of 64 rows
// each, one splitter warpgroup, one TMA warpgroup (one thread of it
// issues). The TMA thread keeps a ring of 4 stages of raw float32 tiles,
// 32 k deep, in shared memory (128-byte swizzle, zero-filled past the
// edges, so any K, M and N are taken), behind mbarriers, running on into
// the next tile while a tile's C is written. The consumers read their A
// fragments straight from the raw tile, whichever its layout (wgmma takes A
// from registers), and split them there; the splitter turns each raw B tile
// into TF32 hi and lo halves laid out K-major (the only layout wgmma takes
// for TF32: for 'nn' and 'tn' this is where B is transposed, with no copy
// in device memory), in a ring of 2 stages. Each k-step of 8 issues three
// wgmma m64nBNk8; two k-steps' six go to a fresh accumulator added to C's
// at round-to-nearest (the tensor cores round each sum toward zero). 'tn'
// reduces K (the step's points) in slices, one a block, each slice's
// partial C written apart and summed in slice order by a second kernel, so
// a result never depends on the blocks' timing. The bias is added in the
// epilogue.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "tile_mma.cuh"

namespace k15 {

constexpr int BM = 128;       // rows of C a block: two warpgroups of 64
constexpr int BK = 32;        // k a stage: one 128-byte swizzled row of floats
constexpr int MAX_BN = 136;   // tile widths 8 to 136 in 8s
constexpr int RAW_STAGES = 4;
constexpr int SPLIT_STAGES = 2;
constexpr int CONSUMERS = 256;
constexpr int SPLITTERS = 128;
constexpr int THREADS = CONSUMERS + SPLITTERS + 128;  // + the TMA warpgroup
constexpr int A_BYTES = BM * BK * 4;
// registers a thread: 128 at launch (65,536 / 512); the splitter and the
// TMA warpgroup give theirs up to the consumers (setmaxnreg draws on the
// block's own: 128 x (208 - 128) x 2 = 128 x (128 - 64) + 128 x (128 - 24)),
// whose two accumulators of BN / 2 floats and 32 A halves need more
constexpr int SPLITTER_REGS = 64, TMA_REGS = 24, CONSUMER_REGS = 208;
constexpr int BOX = 32 * BK * 4;  // a 32 x 32 raw box

enum { FORM_NT = 0, FORM_NN = 1, FORM_TN = 2 };

template <int BN>
struct Smem {
  // a K-major raw B is one box of BN rows, an N-major one boxes of 32 columns
  static constexpr int RAW_B = BN * 128 > (BN + 31) / 32 * BOX ? BN * 128 : (BN + 31) / 32 * BOX;
  static constexpr int SPLIT = BN * 128;
  static constexpr int OFF_B = RAW_STAGES * A_BYTES;
  static constexpr int OFF_HI = OFF_B + RAW_STAGES * RAW_B;
  static constexpr int OFF_LO = OFF_HI + SPLIT_STAGES * SPLIT;
  static constexpr int OFF_BAR = OFF_LO + SPLIT_STAGES * SPLIT;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * RAW_STAGES + 2 * SPLIT_STAGES) + 1024;
};

struct Args {
  float* c;            // C, or the slices' partial Cs
  const float* bias;   // n floats or null
  int m, n, k;
  int n_tiles, tiles;  // C's tiles: n_tiles a row of them
  int work;            // tiles x slices, the items the blocks take in turn
  int k_tiles;         // stages a slice reduces
  long long slice;     // floats between slices' partial Cs
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the barrier's phase differs from parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a K-major operand of 128-byte rows, 128-byte swizzle, 8-row groups 1024
// bytes apart (the layout TMA's 128-byte swizzle writes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the registers an asynchronous wgmma reads or writes where they are
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void split4(const float4& v, float4& hi, float4& lo) {
  uint32_t h, l;
  nw::tf32_split(v.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  nw::tf32_split(v.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  nw::tf32_split(v.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  nw::tf32_split(v.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d (64 x N, f32) = a (64 x 8 TF32, registers) b (N x 8 TF32, shared,
// K-major) + (acc ? d : 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "%8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<40> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, "
        "p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, "
        "%25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<56> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<72> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, "
        "1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, "
        "%43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<88> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<104> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, "
        "%60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<120> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
        "{%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<136> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <int FORM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    split_tf32_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, Args p) {
  constexpr bool A_KMAJOR = FORM != FORM_TN;
  constexpr bool B_KMAJOR = FORM == FORM_NT;
  constexpr int B_BOXES = (BN + 31) / 32;
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = nw::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::OFF_BAR;
  auto raw_full = [&](int s) { return bars + 8 * s; };
  auto raw_empty = [&](int s) { return bars + 8 * (RAW_STAGES + s); };
  auto split_full = [&](int s) { return bars + 8 * (2 * RAW_STAGES + s); };
  auto split_empty = [&](int s) { return bars + 8 * (2 * RAW_STAGES + SPLIT_STAGES + s); };

  const int tid = threadIdx.x;
  const int k_all = (p.k + BK - 1) / BK;
  // work item w: tile w % tiles (n fastest, so that a row of tiles shares
  // its A in L2) of slice w / tiles; every role walks the same items, and
  // the rings' stage count runs on across them
  struct Item {
    int n0, m0, kt0, n_k, slice;
  };
  auto item = [&](int w) {
    const int tile = w % p.tiles, slice = w / p.tiles;
    const int kt0 = slice * p.k_tiles;
    return Item{(tile % p.n_tiles) * BN, (tile / p.n_tiles) * BM, kt0, min(k_all - kt0, p.k_tiles),
                slice};
  };

  if (tid == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(raw_empty(s), CONSUMERS + SPLITTERS);
    }
    for (int s = 0; s < SPLIT_STAGES; ++s) {
      mbar_init(split_full(s), SPLITTERS);
      mbar_init(split_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS + SPLITTERS) {
    // the TMA warpgroup: one thread keeps the raw ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TMA_REGS));
    if (tid == CONSUMERS + SPLITTERS) {
      constexpr uint32_t bytes = A_BYTES + (B_KMAJOR ? BN * 128 : B_BOXES * BOX);
      int it = 0;
      for (int w = blockIdx.x; w < p.work; w += gridDim.x) {
        const Item x = item(w);
        for (int i = 0; i < x.n_k; ++i, ++it) {
          const int s = it % RAW_STAGES;
          mbar_wait(raw_empty(s), ((it / RAW_STAGES) & 1) ^ 1);
          mbar_expect_tx(raw_full(s), bytes);
          const int k0 = (x.kt0 + i) * BK;
          const uint32_t a = base + s * A_BYTES;
          if (A_KMAJOR) {
            tma_load(a, &map_a, raw_full(s), k0, x.m0);
          } else {
#pragma unroll
            for (int j = 0; j < BM / 32; ++j)
              tma_load(a + j * BOX, &map_a, raw_full(s), x.m0 + 32 * j, k0);
          }
          const uint32_t b = base + S::OFF_B + s * S::RAW_B;
          if (B_KMAJOR) {
            tma_load(b, &map_b, raw_full(s), k0, x.n0);
          } else {
#pragma unroll
            for (int j = 0; j < B_BOXES; ++j)
              tma_load(b + j * BOX, &map_b, raw_full(s), x.n0 + 32 * j, k0);
          }
        }
      }
    }
  } else if (tid >= CONSUMERS) {
    // the splitter: raw B -> K-major TF32 hi and lo
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SPLITTER_REGS));
    const int st = tid - CONSUMERS;
    int it = 0;
    for (int w = blockIdx.x; w < p.work; w += gridDim.x) {
      const int n_k = item(w).n_k;
      for (int i = 0; i < n_k; ++i, ++it) {
        const int s = it % RAW_STAGES, s2 = it % SPLIT_STAGES;
        mbar_wait(raw_full(s), (it / RAW_STAGES) & 1);
        mbar_wait(split_empty(s2), ((it / SPLIT_STAGES) & 1) ^ 1);
        const uint8_t* src = smem + S::OFF_B + s * S::RAW_B;
        uint8_t* hi = smem + S::OFF_HI + s2 * S::SPLIT;
        uint8_t* lo = smem + S::OFF_LO + s2 * S::SPLIT;
        if (B_KMAJOR) {
          // the raw tile is K-major already: the same 16-byte chunk in and out
          for (int c = st; c < BN * 8; c += SPLITTERS) {
            float4 h, l;
            split4(*reinterpret_cast<const float4*>(src + 16 * c), h, l);
            *reinterpret_cast<float4*>(hi + 16 * c) = h;
            *reinterpret_cast<float4*>(lo + 16 * c) = l;
          }
        } else {
          // raw boxes of 32 k rows x 32 n: a thread transposes a 4 x 4 block,
          // n chunk cn of a box and k chunk ck, reading 4 k rows and writing
          // 4 n rows; lanes l of 8 take cn = l, ck = l + shift, so that each
          // 8 lanes' 16-byte accesses fall on 8 distinct bank groups both ways
          for (int idx = st; idx < 64 * B_BOXES; idx += SPLITTERS) {
            const int box = idx >> 6, cn = idx & 7, ck = (cn + (idx >> 3)) & 7;
            const int n = 32 * box + 4 * cn;
            if (n >= BN) continue;
            float4 v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int k = 4 * ck + r;
              v[r] = *reinterpret_cast<const float4*>(src + box * BOX + k * 128 +
                                                      ((cn ^ (k & 7)) << 4));
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int row = n + j;
              const float4 t =
                  make_float4(lane(v[0], j), lane(v[1], j), lane(v[2], j), lane(v[3], j));
              float4 h, l;
              split4(t, h, l);
              const int off = row * 128 + ((ck ^ (row & 7)) << 4);
              *reinterpret_cast<float4*>(hi + off) = h;
              *reinterpret_cast<float4*>(lo + off) = l;
            }
          }
        }
        // the halves are read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(split_full(s2));
        mbar_arrive(raw_empty(s));
      }
    }
  } else {
    // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of a tile
    const int wg = tid >> 7, warp = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
    const int mr = 64 * wg + 16 * warp + g;  // a0's row; a1's is mr + 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // the tensor cores round each wgmma's sum toward zero: two k-steps'
    // products (16 k: the four small ones, then the two large) go to a fresh
    // accumulator, added to acc at round-to-nearest, so that two truncations
    // in 16 k fall at the scale of their own sums. One accumulator chained
    // over a stage puts 11 at the stage's partial sum and leans every C
    // toward zero, which the step's sums over points carry (PERF.md section 6)
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) part[j] = 0.0f;
    int it = 0;
    for (int w = blockIdx.x; w < p.work; w += gridDim.x) {
      const Item x = item(w);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
      for (int i = 0; i < x.n_k; ++i, ++it) {
        const int s = it % RAW_STAGES, s2 = it % SPLIT_STAGES;
        mbar_wait(raw_full(s), (it / RAW_STAGES) & 1);
        const float* a = reinterpret_cast<const float*>(smem + s * A_BYTES);
        uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // the TF32 A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
            const int m = mr + 8 * (q & 1), k = 8 * kk + t + 4 * (q >> 1);
            const int at = A_KMAJOR ? 32 * m + (((k >> 2) ^ (m & 7)) << 2) + (k & 3)
                                    : 1024 * (m >> 5) + 32 * k +
                                          ((((m & 31) >> 2) ^ (k & 7)) << 2) + (m & 3);
            nw::tf32_split(a[at], a_hi[kk][q], a_lo[kk][q]);
          }
        }
        mbar_arrive(raw_empty(s));
        mbar_wait(split_full(s2), (it / SPLIT_STAGES) & 1);
        const uint32_t hi = base + S::OFF_HI + s2 * S::SPLIT;
        const uint32_t lo = base + S::OFF_LO + s2 * S::SPLIT;
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) hold(part[j]);
          wgmma_fence();
          Wgmma<BN>::mma(part, a_lo[h], sw128_desc(hi + 32 * h), 0);
          Wgmma<BN>::mma(part, a_hi[h], sw128_desc(lo + 32 * h), 1);
          Wgmma<BN>::mma(part, a_lo[h + 1], sw128_desc(hi + 32 * (h + 1)), 1);
          Wgmma<BN>::mma(part, a_hi[h + 1], sw128_desc(lo + 32 * (h + 1)), 1);
          Wgmma<BN>::mma(part, a_hi[h], sw128_desc(hi + 32 * h), 1);
          Wgmma<BN>::mma(part, a_hi[h + 1], sw128_desc(hi + 32 * (h + 1)), 1);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            hold(part[j]);
            acc[j] += part[j];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hold(a_hi[kk][q]);
            hold(a_lo[kk][q]);
          }
        }
        mbar_arrive(split_empty(s2));
      }
      // the accumulator: acc[4j + 2h + e] is row g + 8 h, column 8 j + 2 t + e;
      // while it is written, the TMA thread and the splitter run ahead into
      // the next item's stages
      float* c = p.c + x.slice * p.slice;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x.m0 + mr + 8 * h;
        if (row >= p.m) continue;
        float* c_row = c + static_cast<long long>(row) * p.n;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = x.n0 + 8 * j + 2 * t;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if ((p.n & 1) == 0) {  // an even width: col + 1 < n wherever col < n
            if (col < p.n) {
              if (p.bias) {
                v0 += p.bias[col];
                v1 += p.bias[col + 1];
              }
              *reinterpret_cast<float2*>(c_row + col) = make_float2(v0, v1);
            }
          } else {
            if (col < p.n) c_row[col] = v0 + (p.bias ? p.bias[col] : 0.0f);
            if (col + 1 < p.n) c_row[col + 1] = v1 + (p.bias ? p.bias[col + 1] : 0.0f);
          }
        }
      }
    }
  }
}

// C = the sum of the slices' partial Cs, in slice order
__global__ void split_tf32_gemm_reduce_kernel(const float* __restrict__ parts, float* __restrict__ c,
                                              long long mn, int slices) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = parts[i];
    for (int z = 1; z < slices; ++z) s += parts[z * mn + i];
    c[i] = s;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, found through the runtime (no link to libcuda)
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major float32 matrix of `outer` rows of `inner` floats, rows `ld`
// floats apart, read in boxes of 32 x box_outer with the 128-byte swizzle
static int encode(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                  long long ld, int box_outer) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return 999;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elems[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                  box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// one block an SM (a block takes ~200 KB of shared memory), each walking
// the work items in turn
static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int FORM, int BN>
static int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Args& p,
                  cudaStream_t stream) {
  auto kernel = split_tf32_gemm_kernel<FORM, BN>;
  constexpr int bytes = Smem<BN>::BYTES;
  static_assert(bytes <= 232448, "a block's shared memory");
  // not a stream operation: legal while a CUDA graph captures
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<p.work < sms ? p.work : sms, THREADS, bytes, stream>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM, int... BNS>
static int launch_bn(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Args& p,
                     cudaStream_t stream, std::integer_sequence<int, BNS...>) {
  int err = -1;
  // the tile widths 8, 16, ..., 136: the instance whose width is bn
  ((bn == 8 * (BNS + 1) ? (err = launch<FORM, 8 * (BNS + 1)>(ma, mb, p, stream), 0) : 0), ...);
  return err;
}

}  // namespace k15

// C (m, n) from A and B in `form` (0 'nt', 1 'nn', 2 'tn'; see the head of
// this file) with row strides lda / ldb (floats), plus bias (n floats, or
// null) in 'nt'; the tile width bn (8 to 136, a multiple of 8); 'tn' reduces k in
// `slices` slices of k_tiles stages of 32 each, written to parts (slices x
// m x n floats) and summed into c (with slices 1, straight into c). Returns
// a cudaError_t value (0 = launched), -1 for arguments the kernel does not
// take, 999 without libcuda's tensor-map encoder, 1000 + a CUresult for
// a tensor map libcuda refused.
extern "C" int nw_split_tf32_gemm(int form, const void* a, long long lda, const void* b,
                                  long long ldb, const void* bias, int m, int n, int k, int bn,
                                  int slices, int k_tiles, void* parts, void* c, void* stream) {
  using namespace k15;
  const bool ok_form = form == FORM_NT || form == FORM_NN || form == FORM_TN;
  if (!ok_form || a == nullptr || b == nullptr || c == nullptr || m < 1 || n < 1 || k < 1 ||
      slices < 1 || k_tiles < 1 || (k + BK - 1) / BK > static_cast<long long>(slices) * k_tiles ||
      (k + BK - 1) / BK <= static_cast<long long>(slices - 1) * k_tiles ||
      (slices > 1 && (parts == nullptr || bias != nullptr)) || (bias != nullptr && form != FORM_NT))
    return -1;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 || lda % 4 ||
      ldb % 4)
    return -1;
  const bool a_kmajor = form != FORM_TN, b_kmajor = form == FORM_NT;
  const long long a_inner = a_kmajor ? k : m, a_outer = a_kmajor ? m : k;
  const long long b_inner = b_kmajor ? k : n, b_outer = b_kmajor ? n : k;
  if (lda < a_inner || ldb < b_inner) return -1;
  CUtensorMap ma, mb;
  int err = encode(&ma, a, a_inner, a_outer, lda, a_kmajor ? BM : 32);
  if (err == 0) err = encode(&mb, b, b_inner, b_outer, ldb, b_kmajor ? bn : 32);
  if (err != 0) return err;
  const int n_tiles = (n + bn - 1) / bn;
  const long long tiles = static_cast<long long>(n_tiles) * ((m + BM - 1) / BM);
  if (bn % 8 || bn < 8 || bn > MAX_BN || tiles * slices > 0x7fffffffLL) return -1;
  Args p;
  p.c = static_cast<float*>(slices > 1 ? parts : c);
  p.bias = static_cast<const float*>(bias);
  p.m = m;
  p.n = n;
  p.k = k;
  p.n_tiles = n_tiles;
  p.tiles = static_cast<int>(tiles);
  p.work = static_cast<int>(tiles * slices);
  p.k_tiles = k_tiles;
  p.slice = static_cast<long long>(m) * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto widths = std::make_integer_sequence<int, MAX_BN / 8>{};
  err = form == FORM_NT   ? launch_bn<FORM_NT>(bn, ma, mb, p, st, widths)
        : form == FORM_NN ? launch_bn<FORM_NN>(bn, ma, mb, p, st, widths)
                          : launch_bn<FORM_TN>(bn, ma, mb, p, st, widths);
  if (err != 0 || slices == 1) return err;
  const long long mn = p.slice;
  const int blocks = static_cast<int>(mn / 256 + 1 < 1024 ? mn / 256 + 1 : 1024);
  split_tf32_gemm_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(parts),
                                                        static_cast<float*>(c), mn, slices);
  return static_cast<int>(cudaGetLastError());
}
