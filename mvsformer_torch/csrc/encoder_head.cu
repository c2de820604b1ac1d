// K4: the FPN encoder head, conv00 -> conv01 -> downsample1, in one launch,
// all three convs on the tensor cores.
//
// Replaces: mvsformer_tpu/ops/pallas/encoder_head.py encoder_head. Contract:
// FPNEncoder's first three ConvNormAct layers (models/fpn.py), each a conv
// without bias, folded BN and leaky-ReLU 0.1:
//   conv00 = 7x7, 3 -> 8;  conv01 = 5x5, 8 -> 8;  down0 = 5x5 stride 2, 8 -> 16.
// imgs [N,3,H,W] -> conv01 [N,8,H,W] and down0 [N,16,ceil(H/2),ceil(W/2)].
// The plain version is ops/encoder_head.py encoder_head_plain.
//
// Bound on the H100: operations on the tensor cores. Per full-resolution
// pixel 7*7*3*8 + 5*5*8*8 + 5*5*8*16/4 = 3,576 multiply-adds, run in 3xTF32
// (three TF32 products each, fp32's accuracy) over 494.7 TFLOP/s dense:
// 0.384 ms for the DTU request (5 views of 1152 x 1536). The bytes (3
// channels read, 8 + 16/4 written: 60 per pixel) need 0.158 ms; BN and
// lrelu 0.008 ms on the CUDA cores. The 8-channel conv00 map never reaches
// device memory.
//
// Design: one block of 8 warps per 32 x 32 tile of conv01 (16 x 16 of
// down0); every layer is an implicit GEMM on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (tf32_mma.cuh): an A fragment
// is 16 pixels, N the 8 (or 16) output channels, and each multiply-add is
// lo*hi + hi*lo + hi*hi over TF32 parts (3xTF32).
//  - Regions: conv01 over the tile with the rows and columns down0 reads,
//    35 x 35 pixels (from the tile's corner - 2); conv00 over 39 x 39; the
//    image over 45 x 46, pixel-major. All three live in dynamic shared
//    memory as fp32, 91,232 B, so two blocks share an SM
//    (encoder_head_blocks_per_sm reports what the card makes of it);
//    conv01's output overlays the image once conv00 is done. Halo work:
//    1.49x the tile's own conv00 and 1.20x its conv01.
//  - What sets the time is the path from shared memory and L1 to the tensor
//    cores, and their issue (python -m mvsformer_torch.k4_variants,
//    PERF.md). So a warp's work item is RW rows of one 16-column fragment
//    (columns 0-15 or 16-31 of the region); for each chunk it loads each A
//    row once, for every kernel row that reads it (up to 7, 5 or 3), and
//    each B fragment once for its RW rows. The columns past 31 (7 of
//    conv00's, 3 of conv01's) form a strip, flattened into fragments (a
//    lane's rows g and g + 8 at their own offsets) that a strip item takes
//    SF at a time. conv00 has 26 row items and 6 strip items, conv01 14
//    and 2, each of equal work: 4 and 2 a warp.
//  - Activations are stored as fp32 and split where they are read, with
//    two logic ops and a subtraction a value (hi = x truncated to TF32, lo
//    = x - hi truncated, within 2^-20 |x|): half the bytes of storing hi
//    and lo, which measured slower.
//  - conv00 (RW = 3, SF = 3): per kernel row ky, K = 7 taps x 3 channels in
//    (kx, ci) order, so a pixel's 21 values of one image row are
//    contiguous; K is padded to 24 (3 chunks of 8, the padding's weights
//    zero). A lane reads its K values of a row as scalars (3 values a
//    pixel: no 8-byte alignment), on distinct banks.
//  - conv01 (RW = 5, SF = 5): K = one tap's 8 channels; a lane's values of
//    a pixel (channels 2t and 2t + 1) are one 8-byte load, and each
//    half-warp reads 4 consecutive pixels: 32 distinct banks.
//  - down0 (2 rows of the 16 x 16 down0 tile a warp): A rows are conv01
//    pixels 2 apart, so conv01's output is stored with its even columns
//    before its odd ones in each row (19 slots each, odd, so neighbours
//    fall on other banks): the pixels a fragment reads at one tap are
//    consecutive. N = 16 as two fragments that share each A fragment.
//  - Zero padding at the image border at every layer: the epilogues apply
//    BN and lrelu and write exact zeros outside the image (lrelu(BN(conv(0)))
//    is not zero, and the next layer pads with zeros). conv01 and down0 go
//    to device memory from the epilogues' registers; a store covers whole
//    32-byte sectors of 4 channel planes.
//  - Weights: pack_kernel (launched by the wrapper before each
//    encoder_head_kernel, from the module's tensors) splits them to TF32 hi
//    and lo (round to nearest) and packs them in B-fragment order (the
//    layouts of ops/tf32.py pack_conv_rows and pack_conv, 12,288 floats)
//    after the folded BNs; a lane reads its (hi, hi, lo, lo) of a fragment
//    with one 16-byte __ldg, from L1 and L2.
//  - The tensor cores round the fp32 sum of each mma toward zero, so each
//    chunk (a kernel column of taps, or conv00's chunk of 8 K values over
//    its 7 rows: 40 to 56 products) is summed from zero and added to the
//    fp32 accumulator in round-to-nearest.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int TH = 32, TW = 32;                 // conv01 tile; the down0 tile is TH/2 x TW/2
constexpr int BH = TH + 3, BW = TW + 3;         // conv01 region, from (ty0 - 2, tx0 - 2)
constexpr int AH = BH + 4, AW = BW + 4;         // conv00 region, from (ty0 - 4, tx0 - 4)
constexpr int IH = AH + 6, IW = AW + 7;         // image region, from (ty0 - 7, tx0 - 7)
constexpr int IRS = 3 * IW;                     // image row stride, in values
constexpr int PS = 8;                           // floats a pixel of conv00's and conv01's outputs
constexpr int kHalf = (BW + 1) / 2 + 1;         // odd: a pixel and its right neighbour on other banks
constexpr int BRS = 2 * kHalf;                  // conv01 row stride, in pixels: even, then odd columns
constexpr int CF = 2;                           // 16-column M fragments of a row; then a strip
constexpr int SW0 = AW - 16 * CF, SW1 = BW - 16 * CF;  // strip widths: 7 and 3 columns
constexpr int RW0 = 3, NB0 = (AH + RW0 - 1) / RW0;  // conv00: rows a row item takes; row bands
constexpr int RW1 = 5, NB1 = (BH + RW1 - 1) / RW1;  // conv01: the same
constexpr int SF0 = 3, SF1 = 5;                     // strip fragments a strip item takes
constexpr int kRowItems0 = NB0 * CF, kStripItems0 = ((AH * SW0 + 15) / 16 + SF0 - 1) / SF0;
constexpr int kRowItems1 = NB1 * CF, kStripItems1 = ((BH * SW1 + 15) / 16 + SF1 - 1) / SF1;
constexpr int RWD = 2;                              // down0: rows a warp takes
constexpr int kImgLoads = (3 * IH * IW + kThreads - 1) / kThreads;
static_assert(SW0 > 0 && SW0 < 16 && SW1 > 0 && SW1 < 16, "a strip is narrower than a fragment");
static_assert(TW / 2 == 16 && TH / 2 == RWD * kWarps, "down0: RWD rows of 16 pixels a warp");
static_assert(kHalf % 2 == 1 && kHalf >= TW / 2 + 2, "conv01's halves: odd, and down0's reads fit");

// The packed weights (floats), written by pack_kernel: the folded BNs,
// then the B fragments of conv00 [7 ky][3 chunks][32 lanes], conv01 [25
// taps][32 lanes] and down0 [25 taps][2 N fragments][32 lanes], as float4s.
constexpr int M00 = 0, A00 = 8, M01 = 16, A01 = 24, MD = 32, AD = 48, kFolds = 64;
constexpr int kW00 = 7 * 3 * 32, kW01 = 25 * 32, kWD = 25 * 2 * 32;  // float4s
constexpr int kPacked = kFolds + 4 * (kW00 + kW01 + kWD);

// Shared memory (floats): conv00's output, then the image tile, which
// conv01's output overlays.
constexpr int kA = AH * AW * PS;
constexpr int kImg = IH * IRS;
constexpr int kB = BH * BRS * PS;
constexpr int kSmemFloats = kA + (kImg > kB ? kImg : kB);
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
// The columns of a fragment past the region read further on (whatever lies
// there: those outputs are not stored), but not past the allocation.
static_assert(kA + (NB0 * RW0 + 5) * IRS + 3 * 16 * CF + 48 <= kSmemFloats &&
              ((NB1 * RW1 + 3) * AW + 16 * CF + 4) * PS <= kSmemFloats,
              "conv00's and conv01's reads stay in shared memory");
static_assert(NB0 * RW0 + 6 <= IH + 1 && NB1 * RW1 + 4 <= AH + 1,
              "a band reads at most one row past the region above it");

__device__ __forceinline__ float lrelu(float x) { return fmaxf(x, 0.1f * x); }

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo within 2^-20 |x|: hi = x truncated to TF32, lo = x - hi (exact
// in fp32) truncated; two logic ops and a subtraction.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// The A fragment of one 8-value K chunk: x0 holds row g's values of
// columns t and t + 4, x1 row g + 8's.
__device__ __forceinline__ void split_a_trunc(float2 x0, float2 x1, uint32_t* ah, uint32_t* al) {
  split_trunc(x0.x, ah[0], al[0]);
  split_trunc(x1.x, ah[1], al[1]);
  split_trunc(x0.y, ah[2], al[2]);
  split_trunc(x1.y, ah[3], al[3]);
}

// Channels 2t and 2t + 1 of one pixel of conv00's or conv01's output, where
// the next layer reads them (p is the pixel's base + (PS / 4) t).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// The A fragment of rows g (at p0) and g + 8 (at p1) from conv00's or
// conv01's output.
__device__ __forceinline__ void load_a(const float* p0, const float* p1, uint32_t* ah,
                                       uint32_t* al) {
  split_a_trunc(ld2(p0), ld2(p1), ah, al);
}

// Lane i % 32 of B fragment i / 32 of the packed weights: (hi b0, hi b1, lo
// b0, lo b1) of output channel 8f + g and GEMM rows 8 chunk + 2t, + 1.
__global__ void pack_kernel(const float* __restrict__ k00, const float* __restrict__ m00,
                            const float* __restrict__ a00, const float* __restrict__ k01,
                            const float* __restrict__ m01, const float* __restrict__ a01,
                            const float* __restrict__ kd, const float* __restrict__ md,
                            const float* __restrict__ ad, float* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 8) {
    packed[M00 + i] = m00[i];
    packed[A00 + i] = a00[i];
    packed[M01 + i] = m01[i];
    packed[A01 + i] = a01[i];
  }
  if (i < 16) {
    packed[MD + i] = md[i];
    packed[AD + i] = ad[i];
  }
  const int lane = i & 31, g = lane >> 2, t = lane & 3;
  float v[2];
  if (i < kW00) {
    // conv00: row j = 8 chunk + 2t (+1) of ky's K is tap kx = j / 3,
    // channel j % 3; rows 21-23 are padding.
    const int chunk = (i >> 5) % 3, ky = (i >> 5) / 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * chunk + 2 * t + e;
      v[e] = j < 21 ? k00[((g * 3 + j % 3) * 7 + ky) * 7 + j / 3] : 0.0f;
    }
  } else if (i < kW00 + kW01) {
    const int tap = (i - kW00) >> 5;
#pragma unroll
    for (int e = 0; e < 2; ++e) v[e] = k01[(g * 8 + 2 * t + e) * 25 + tap];
  } else if (i < kW00 + kW01 + kWD) {
    const int f = ((i - kW00 - kW01) >> 5) & 1, tap = (i - kW00 - kW01) >> 6;
#pragma unroll
    for (int e = 0; e < 2; ++e) v[e] = kd[((8 * f + g) * 8 + 2 * t + e) * 25 + tap];
  } else {
    return;
  }
  uint32_t h0, l0, h1, l1;
  split_tf32(v[0], h0, l0);
  split_tf32(v[1], h1, l1);
  reinterpret_cast<float4*>(packed + kFolds)[i] = make_float4(
      __uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
}

__global__ void __launch_bounds__(kThreads, 2)
encoder_head_kernel(const float* __restrict__ imgs,    // [N, 3, H, W]
                    const float* __restrict__ packed,  // [kPacked], from pack_kernel
                    float* __restrict__ conv01,        // [N, 8, H, W]
                    float* __restrict__ down0,         // [N, 16, Ho, Wo]
                    int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;         // conv00 [AH][AW][PS]
  float* s_img = smem + kA;  // image [IH][IW][3]
  float* s_b = smem + kA;    // conv01 [BH][BRS][PS], over the image once conv00 is done
  const float4* w00 = reinterpret_cast<const float4*>(packed + kFolds);
  const float4* w01 = w00 + kW00;
  const float4* wd = w01 + kW01;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lt = (PS / 4) * t;  // the lane's channels 2t, 2t + 1 within a pixel
  const size_t HW = (size_t)H * W;

  // The image tile, pixel-major, zero outside the image. A thread issues
  // all its loads before its first store.
  {
    const float* img = imgs + (size_t)n * 3 * HW;
    float x[kImgLoads];
#pragma unroll
    for (int k = 0; k < kImgLoads; ++k) {
      const int i = tid + k * kThreads;
      const int row = i / IW, c = i - row * IW;  // row = ci * IH + r
      const int ci = row / IH, gy = ty0 - 7 + row - ci * IH, gx = tx0 - 7 + c;
      x[k] = (i < 3 * IH * IW && gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? __ldg(img + ci * HW + (size_t)gy * W + gx) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kImgLoads; ++k) {
      const int i = tid + k * kThreads;
      if (i >= 3 * IH * IW) break;
      const int row = i / IW, c = i - row * IW;
      const int ci = row / IH, r = row - ci * IH;
      s_img[r * IRS + 3 * c + ci] = x[k];
    }
  }
  __syncthreads();

  // conv00 over the 39 x 39 region. Work items: RW0 rows of one of the two
  // 16-column fragments of columns 0-31, then SF0 fragments of the strip of
  // columns 32-38 (flattened, a lane's rows g and g + 8 at their own
  // offsets); each item is 63 steps of 3xTF32 (kRowItems0 + kStripItems0 =
  // 4 per warp).
  {
    const float m0 = __ldg(packed + M00 + 2 * t), m1 = __ldg(packed + M00 + 2 * t + 1);
    const float b0 = __ldg(packed + A00 + 2 * t), b1 = __ldg(packed + A00 + 2 * t + 1);
    auto store = [&](int r, int c, float a0, float a1) {
      const int gy = ty0 - 4 + r, gx = tx0 - 4 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      store_pair(s_a + (r * AW + c) * PS + lt, in ? lrelu(a0 * m0 + b0) : 0.0f,
                 in ? lrelu(a1 * m1 + b1) : 0.0f);
    };
    for (int u = warp; u < kRowItems0 + kStripItems0; u += kWarps) {
      if (u < kRowItems0) {
        const int r0 = (u / CF) * RW0, c0 = 16 * (u % CF);
        // Row g of the fragment at image row R: pixel c0 + g of that row,
        // from the lane's K offset 2t; row g + 8 is 8 pixels (24 values) on.
        const float* base = s_img + r0 * IRS + 3 * (c0 + g) + 2 * t;
        float acc[RW0][4];
#pragma unroll
        for (int j = 0; j < RW0; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 1
        for (int q = 0; q < 3; ++q) {
          // Output row r0 + j at kernel row ky reads image row R = j + ky:
          // each of the RW0 + 6 rows is loaded and split at its first use,
          // for every (j, ky) that reads it. The chunk's 56 products are
          // summed from zero.
          float part[RW0][4];
#pragma unroll
          for (int j = 0; j < RW0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
          uint32_t ah[RW0 + 6][4], al[RW0 + 6][4];
#pragma unroll
          for (int ky = 0; ky < 7; ++ky) {
            const float4 b = __ldg(w00 + (ky * 3 + q) * 32 + lane);
#pragma unroll
            for (int j = 0; j < RW0; ++j) {
              const int R = j + ky;
              if (ky == 0 || j == RW0 - 1) {
                const float* s0 = base + R * IRS + 8 * q;
                split_a_trunc(make_float2(s0[0], s0[1]), make_float2(s0[24], s0[25]), ah[R],
                              al[R]);
              }
            }
#pragma unroll
            for (int j = 0; j < RW0; ++j) mma_3xtf32(part[j], ah[j + ky], al[j + ky], b);
          }
#pragma unroll
          for (int j = 0; j < RW0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
        }
        // Element 2h + e of row j is pixel (r0 + j, c0 + g + 8h), channel 2t + e.
#pragma unroll
        for (int j = 0; j < RW0; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (r0 + j < AH) store(r0 + j, c0 + g + 8 * h, acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        const int f0 = (u - kRowItems0) * SF0;
        int off[SF0][2];  // rows g and g + 8 of strip fragment f0 + s: image value offsets
#pragma unroll
        for (int s = 0; s < SF0; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = min((f0 + s) * 16 + g + 8 * h, AH * SW0 - 1);
            const int r = m / SW0;
            off[s][h] = r * IRS + 3 * (16 * CF + m - r * SW0) + 2 * t;
          }
        float acc[SF0][4];
#pragma unroll
        for (int j = 0; j < SF0; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 1
        for (int q = 0; q < 3; ++q) {
          float part[SF0][4];
#pragma unroll
          for (int j = 0; j < SF0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
          for (int ky = 0; ky < 7; ++ky) {
            const float4 b = __ldg(w00 + (ky * 3 + q) * 32 + lane);
            uint32_t ah[SF0][4], al[SF0][4];
#pragma unroll
            for (int j = 0; j < SF0; ++j) {
              const float* p0 = s_img + off[j][0] + ky * IRS + 8 * q;
              const float* p1 = s_img + off[j][1] + ky * IRS + 8 * q;
              split_a_trunc(make_float2(p0[0], p0[1]), make_float2(p1[0], p1[1]), ah[j], al[j]);
            }
#pragma unroll
            for (int j = 0; j < SF0; ++j) mma_3xtf32(part[j], ah[j], al[j], b);
          }
#pragma unroll
          for (int j = 0; j < SF0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
        }
#pragma unroll
        for (int j = 0; j < SF0; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (f0 + j) * 16 + g + 8 * h;
            if (m >= AH * SW0) continue;
            const int r = m / SW0;
            store(r, 16 * CF + m - r * SW0, acc[j][2 * h], acc[j][2 * h + 1]);
          }
      }
    }
  }
  __syncthreads();  // the image tile is dead from here: conv01's output overlays it

  // conv01 over the 35 x 35 region, work items as conv00's: RW1 rows of one
  // of the fragments of columns 0-31, then SF1 fragments of the strip of
  // columns 32-34; each item is 125 steps (2 per warp). The tile's own
  // pixels also go to device memory.
  {
    const float m0 = __ldg(packed + M01 + 2 * t), m1 = __ldg(packed + M01 + 2 * t + 1);
    const float b0 = __ldg(packed + A01 + 2 * t), b1 = __ldg(packed + A01 + 2 * t + 1);
    auto store = [&](int r, int c, float a0, float a1) {
      const int gy = ty0 - 2 + r, gx = tx0 - 2 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float v0 = in ? lrelu(a0 * m0 + b0) : 0.0f;
      const float v1 = in ? lrelu(a1 * m1 + b1) : 0.0f;
      store_pair(s_b + (r * BRS + (c & 1) * kHalf + (c >> 1)) * PS + lt, v0, v1);
      if (in && r >= 2 && r < TH + 2 && c >= 2 && c < TW + 2) {
        float* o = conv01 + ((size_t)n * 8 + 2 * t) * HW + (size_t)gy * W + gx;
        o[0] = v0;
        o[HW] = v1;
      }
    };
    for (int u = warp; u < kRowItems1 + kStripItems1; u += kWarps) {
      if (u < kRowItems1) {
        const int r0 = (u / CF) * RW1, c0 = 16 * (u % CF);
        const float* base = s_a + (r0 * AW + c0 + g) * PS + lt;  // row g; g + 8 is 8 pixels on
        float acc[RW1][4];
#pragma unroll
        for (int j = 0; j < RW1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 1
        for (int kx = 0; kx < 5; ++kx) {
          // Output row r0 + j at tap (ky, kx) reads conv00 row R = j + ky,
          // loaded once for the kernel column; its 40 products are summed
          // from zero.
          float part[RW1][4];
#pragma unroll
          for (int j = 0; j < RW1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
          uint32_t ah[RW1 + 4][4], al[RW1 + 4][4];
#pragma unroll
          for (int ky = 0; ky < 5; ++ky) {
            const float4 b = __ldg(w01 + (ky * 5 + kx) * 32 + lane);
#pragma unroll
            for (int j = 0; j < RW1; ++j) {
              const int R = j + ky;
              if (ky == 0 || j == RW1 - 1) {
                const float* q = base + (R * AW + kx) * PS;
                load_a(q, q + 8 * PS, ah[R], al[R]);
              }
            }
#pragma unroll
            for (int j = 0; j < RW1; ++j) mma_3xtf32(part[j], ah[j + ky], al[j + ky], b);
          }
#pragma unroll
          for (int j = 0; j < RW1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
        }
#pragma unroll
        for (int j = 0; j < RW1; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (r0 + j < BH) store(r0 + j, c0 + g + 8 * h, acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        const int f0 = (u - kRowItems1) * SF1;
        int off[SF1][2];  // rows g and g + 8 of strip fragment f0 + s: conv00 offsets
#pragma unroll
        for (int s = 0; s < SF1; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = min((f0 + s) * 16 + g + 8 * h, BH * SW1 - 1);
            const int r = m / SW1;
            off[s][h] = (r * AW + 16 * CF + m - r * SW1) * PS + lt;
          }
        float acc[SF1][4];
#pragma unroll
        for (int j = 0; j < SF1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 1
        for (int kx = 0; kx < 5; ++kx) {
          float part[SF1][4];
#pragma unroll
          for (int j = 0; j < SF1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
          for (int ky = 0; ky < 5; ++ky) {
            const float4 b = __ldg(w01 + (ky * 5 + kx) * 32 + lane);
            uint32_t ah[SF1][4], al[SF1][4];
#pragma unroll
            for (int j = 0; j < SF1; ++j)
              load_a(s_a + off[j][0] + (ky * AW + kx) * PS, s_a + off[j][1] + (ky * AW + kx) * PS,
                     ah[j], al[j]);
#pragma unroll
            for (int j = 0; j < SF1; ++j) mma_3xtf32(part[j], ah[j], al[j], b);
          }
#pragma unroll
          for (int j = 0; j < SF1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
        }
#pragma unroll
        for (int j = 0; j < SF1; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (f0 + j) * 16 + g + 8 * h;
            if (m >= BH * SW1) continue;
            const int r = m / SW1;
            store(r, 16 * CF + m - r * SW1, acc[j][2 * h], acc[j][2 * h + 1]);
          }
      }
    }
  }
  __syncthreads();

  // down0: warp w computes rows 2w and 2w + 1 of the 16 x 16 tile. Output
  // (oy, ox) reads conv01 rows 2oy - 2 .. 2oy + 2 and columns 2ox - 2 ..
  // 2ox + 2: region rows 2 oy' + ky (oy' = oy - ty0 / 2) and columns 2i + kx
  // (i = ox - tx0 / 2), slot i + kx / 2 of the row's kx-parity half.
  {
    const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
    const int r0 = RWD * warp;
    float acc[2][RWD][4];  // [N fragment][row]
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < RWD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.0f;
    const float* base = s_b + (2 * r0 * BRS + g) * PS + lt;
#pragma unroll 1
    for (int kx = 0; kx < 5; ++kx) {
      // Output row r0 + j at kernel row ky reads region row 2 r0 + R, R =
      // 2j + ky: each of the 7 rows is loaded at its first use.
      float part[2][RWD][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < RWD; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[f][j][e] = 0.0f;
      const float* col = base + ((kx & 1) * kHalf + (kx >> 1)) * PS;
      uint32_t ah[2 * RWD + 3][4], al[2 * RWD + 3][4];
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        const int tap = ky * 5 + kx;
        const float4 bf0 = __ldg(wd + (tap * 2) * 32 + lane);
        const float4 bf1 = __ldg(wd + (tap * 2 + 1) * 32 + lane);
#pragma unroll
        for (int j = 0; j < RWD; ++j) {
          const int R = 2 * j + ky;
          if (j == RWD - 1 || ky < 2) {
            const float* q = col + R * BRS * PS;
            load_a(q, q + 8 * PS, ah[R], al[R]);
          }
        }
#pragma unroll
        for (int j = 0; j < RWD; ++j) {
          mma_3xtf32(part[0][j], ah[2 * j + ky], al[2 * j + ky], bf0);
          mma_3xtf32(part[1][j], ah[2 * j + ky], al[2 * j + ky], bf1);
        }
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < RWD; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][j][e] += part[f][j][e];
    }
#pragma unroll
    for (int j = 0; j < RWD; ++j) {
      const int oy = ty0 / 2 + r0 + j;
      if (oy >= Ho) continue;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ox = tx0 / 2 + g + 8 * (e >> 1);
          const int oc = 8 * f + 2 * t + (e & 1);
          if (ox < Wo)
            down0[((size_t)n * 16 + oc) * Ho * Wo + (size_t)oy * Wo + ox] =
                lrelu(acc[f][j][e] * __ldg(packed + MD + oc) + __ldg(packed + AD + oc));
        }
    }
  }
}

}  // namespace

// Writes the weights of one encoder head, as encoder_head_f32 reads them,
// into packed [encoder_head_packed_floats()].
extern "C" int encoder_head_pack_f32(const float* k00, const float* m00, const float* a00,
                                     const float* k01, const float* m01, const float* a01,
                                     const float* kd, const float* md, const float* ad,
                                     float* packed, void* stream) {
  constexpr int kItems = kW00 + kW01 + kWD;
  pack_kernel<<<(kItems + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k00, m00, a00, k01, m01, a01, kd, md, ad, packed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int encoder_head_packed_floats() { return kPacked; }

extern "C" int encoder_head_f32(const float* imgs, const float* packed, float* conv01,
                                float* down0, int N, int H, int W, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || (H + TH - 1) / TH > 65535) return -1;
  // Per device and cheap: set on every call so a second GPU is covered too.
  cudaError_t err = cudaFuncSetAttribute(
      encoder_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  encoder_head_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      imgs, packed, conv01, down0, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel (negative: a CUDA error), for the
// occupancy the design note promises.
extern "C" int encoder_head_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      encoder_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, encoder_head_kernel, kThreads,
                                                        kSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
