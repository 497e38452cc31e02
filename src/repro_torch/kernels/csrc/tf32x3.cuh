// 3xTF32 products on mma.sync.m16n8k8 (fp32 accumulators), shared by
// rwkv_scan.cu and flash_attention.cu; the build hashes every header of
// this directory into each kernel library's name.
//
// An operand x is split into hi = tf32(x) and lo = tf32(x - hi); a
// product takes hi lo + lo hi + hi hi, which is within a few fp32
// roundings of the fp32 product (the lo lo term is below them). A bf16
// value is exact in TF32 (lo = 0), so where the B operand is a raw bf16
// input the hi lo term is skipped.
#pragma once
#include <cuda_bf16.h>

namespace tf32x3 {

template <typename T> constexpr bool kExactInTf32 = false;
template <> constexpr bool kExactInTf32<__nv_bfloat16> = true;

// Round to TF32 (nearest, ties away from zero), as cvt.rna.tf32.f32 does,
// in two integer operations: the conversion unit runs at a quarter of the
// integer rate and was the products' bottleneck.
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4). A (16 x 8, rows
// m, columns k): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8,
// q + 4). B (8 x 8, k x n): b0 (q, g), b1 (q + 4, g). C (16 x 8): c0 (g,
// 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1). The k axis may
// be taken in any order that A and B share: an accumulator tile C of one
// product is the A fragment (c0, c2, c1, c3) of the next with k = 2q in
// place of q and 2q + 1 in place of q + 4.
struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  const float x[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(x[i]);
    f.lo[i] = tf32(x[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

// kExact: b0 and b1 are exact in TF32 (hi = the value, lo = 0).
template <bool kExact = false>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const float x[2] = {b0, b1};
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f.hi[i] = kExact ? __float_as_uint(x[i]) : tf32(x[i]);
    f.lo[i] = kExact ? 0u : tf32(x[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

// c: the four accumulators of an m16n8 tile.
__device__ __forceinline__ void mma(float* c, const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b, 3xTF32; kBLo = false when b is exact in TF32.
template <bool kBLo>
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  if (kBLo) mma(c, a.hi, b.lo);
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.hi);
}

}  // namespace tf32x3
