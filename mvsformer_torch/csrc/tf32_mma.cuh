// 3xTF32 on mma.sync.m16n8k8: the device helpers K2 (vis_net.cu) and K5
// (fpn_level.cu) share. The plain side (the TF32 split and the B-fragment
// packing of the weights) is mvsformer_torch/ops/tf32.py.
//
// Fragment layout (PTX ISA, mma.m16n8k8 .tf32): lane 4g + t holds A rows g
// and g + 8 at columns t and t + 4, B rows t and t + 4 at column g, and the
// D elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). The kernels
// order K within a chunk of 8 input channels so that columns t and t + 4 are
// channels 2t and 2t + 1: a lane's two A values of a pixel are one float2.
//
// The tensor cores round the fp32 sum of each mma toward zero, so a long
// chain of them drifts: sum each chunk of 8 channels from zero and add it to
// the fp32 accumulator in round-to-nearest.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), as ops/tf32.py
// split_tf32: cvt.rna leaves the 13 low mantissa bits zero, and x - hi is
// exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// The A fragment of one 8-channel chunk, split into hi and lo: x0 holds
// row g's channels 2t and 2t + 1 (columns t and t + 4), x1 row g + 8's.
__device__ __forceinline__ void split_a(float2 x0, float2 x1, uint32_t* ah, uint32_t* al) {
  split_tf32(x0.x, ah[0], al[0]);
  split_tf32(x1.x, ah[1], al[1]);
  split_tf32(x0.y, ah[2], al[2]);
  split_tf32(x1.y, ah[3], al[3]);
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// One multiply-add step in 3xTF32: the small cross terms, then hi * hi.
// b holds the lane's B fragment as (hi b0, hi b1, lo b0, lo b1).
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah, const uint32_t* al,
                                           float4 b) {
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
}
