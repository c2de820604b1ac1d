// K2: the visibility CNN, entropy map -> per-pixel view weight, in one launch,
// its two 16-channel 3x3 convs on the tensor cores.
//
// Replaces: mvsformer_tpu/ops/pallas/vis_net.py fused_visibility. Contract:
// the flax VisibilityNet eval path (models/stagenet.py) = three
// [3x3 conv (no bias), folded BN, ReLU] layers 1 -> 16 -> 16 -> 8, a 1x1 conv
// 8 -> 1 with bias, and a sigmoid, zero-padded at the image border at every
// layer. The plain version is ops/vis_net.py visibility_net_plain; the
// wrapper folds BN into (mul, add) in fp32.
//
// Bound on the H100: operations on the tensor cores. Per output pixel the
// convs are 144 + 2,304 + 1,152 multiply-adds (and 8 in the head); layers 1
// and 2 (3,456, 96%) run in 3xTF32, three TF32 products per multiply-add
// over 494.7 TFLOP/s dense: 0.297 ms at stage 4 of the DTU request (4 views
// of 1152 x 1536), 0.394 ms per request. Layer 0, BN, ReLU, the head and the
// sigmoid (~430 flop per pixel) take 0.060 ms per request on the CUDA
// cores, the bytes (an entropy read and a weight write, 8 per pixel) 0.022.
// The 16/16/8-channel activations never reach device memory.
//
// Design: one block of 8 warps per 16 x 16 output tile.
//  - The entropy tile with a 3-pixel halo and the parameters of layer 0,
//    the folded BNs and the head sit in shared memory; layer 0's weights as
//    [tap][channel], so a float4 broadcast gives one tap's weights of four
//    channels.
//  - Layer 0 (1 -> 16, on the CUDA cores) fills the 20 x 20 region of the
//    tile with a 2-pixel halo; a thread forms 8 channels of a pixel.
//  - Activations are pixel-major, 16 channels innermost, with a pixel
//    stride of PS = 24 floats: a lane's float2 (channels 2t and 2t + 1) of
//    four consecutive pixels covers banks 0-7, 24-31, 16-23 and 8-15, so
//    the 16 lanes of a half-warp hit 32 distinct banks.
//  - Layer 1 (16 -> 16) is an implicit GEMM on
//    mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 over the 18 x 18 region
//    with a 1-pixel halo, flattened: M = 324 pixels in 21 M fragments (the
//    last one part-filled), N = 16 (two N fragments), K = 16 channels x 9
//    taps (two chunks of 8). A lane's rows g and g + 8 may lie in different
//    image rows, so it computes its two base offsets once per M fragment.
//    A warp takes MF = 3 M fragments at a time (7 of the 8 warps, one pass),
//    so each B fragment it loads serves three. The epilogue applies BN and
//    ReLU and stores one float2 per (pixel, N fragment) in the same layout;
//    positions outside the image are written as exact zeros after BN and
//    ReLU (relu(BN(conv(0))) is not zero, and the next layer pads with
//    zeros).
//  - Layer 2 (16 -> 8): M = the tile's 16 rows, one M fragment per row, a
//    warp owning RW = 2 rows; N = 8, so each split A fragment feeds a
//    single N fragment. Each layer-1 row a warp reads is loaded and split
//    once per (chunk, kx), for the up to three (row, ky) that read it, and
//    each B fragment serves the warp's RW M fragments. BN, ReLU, the 1x1
//    head and the sigmoid run from registers: a lane weights its two
//    channels of pixels g and g + 8 by k3, two xor shuffles sum the quad,
//    and one lane per pixel adds b3 and writes the sigmoid. Layer 2's output
//    never reaches shared memory.
//  - A is split into hi = tf32(x) and lo = tf32(x - hi) as it is loaded.
//    The weights of layers 1 and 2 are split and packed in B-fragment order
//    (the layout of ops/tf32.py pack_conv3x3, 6,912 floats) by pack_kernel,
//    which the wrapper launches before each visibility_kernel: one launch
//    from the module's tensors instead of a dozen small PyTorch ops, whose
//    host time was several times the kernel's at the small stages. A lane
//    reads its B fragment with one 16-byte __ldg, from L1 / L2. Each
//    8-channel chunk is summed from zero (tf32_mma.cuh), which keeps fp32's
//    accuracy.
//  - Shared memory: 4 * ((400 + 324) * 24 + 22 * 22 + 236) = 71,440 B.
//    With at most 80 registers a thread (__launch_bounds__(256, 3)) three
//    blocks share an SM (visibility_net_blocks_per_sm reports what the card
//    makes of it), so one block's layer 0 and barriers overlap the others'
//    tensor-core work; at MF = 3, ptxas spills 88 bytes. Halo recompute:
//    layer 1 runs on 336 pixels (21 fragments) and layer 0 on 400 for 256
//    outputs.
//  - Measured against its alternatives (python -m mvsformer_torch.k2_variants,
//    PERF.md): MF = 2, the weights in shared memory (two blocks per SM) and
//    16 x 32 tiles (one block per SM) were slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 3;          // the occupancy __launch_bounds__ asks for
constexpr int TH = 16, TW = 16;          // output tile; a layer-2 M fragment is 16 pixels of a row
constexpr int IH = TH + 6, IW = TW + 6;  // entropy tile (3-pixel halo)
constexpr int AH = TH + 4, AW = TW + 4;  // layer-0 output (2-pixel halo)
constexpr int BH = TH + 2, BW = TW + 2;  // layer-1 output (1-pixel halo)
constexpr int kPixA = AH * AW, kPixB = BH * BW;
constexpr int PS = 24;                              // floats per activation pixel
constexpr int MF = 3;                               // layer-1 M fragments a warp takes at once
constexpr int kGroups1 = (kPixB + 16 * MF - 1) / (16 * MF);
constexpr int FPR = TW / 16;                        // layer-2 M fragments per tile row
constexpr int RW = TH * FPR / kWarps;               // layer-2 rows per warp
static_assert(TW % 16 == 0 && RW * kWarps == TH * FPR, "layer 2: the warps cover the tile");

// The packed weights (floats), written by pack_kernel: the parameters,
// then layers 1 and 2's B fragments.
constexpr int K0 = 0;         // [9 taps][16]: layer 0's weights
constexpr int M0 = K0 + 144;  // [16] folded BN scale
constexpr int A0 = M0 + 16;   // [16] folded BN shift
constexpr int M1 = A0 + 16;   // [16]
constexpr int A1 = M1 + 16;   // [16]
constexpr int M2 = A1 + 16;   // [8]
constexpr int A2 = M2 + 8;    // [8]
constexpr int K3 = A2 + 8;    // [8] the head's weights
constexpr int B3 = K3 + 8;    // [1] the head's bias
constexpr int kParams = B3 + 1;
constexpr int kParamsPad = (kParams + 3) / 4 * 4;
constexpr int kW1 = 2 * 9 * 2 * 32;  // float4s: [2 chunks][9 taps][2 N fragments][32 lanes]
constexpr int kW2 = 2 * 9 * 1 * 32;  // float4s: [2 chunks][9 taps][1][32 lanes]
constexpr int kPacked = kParamsPad + 4 * (kW1 + kW2);

// Shared memory (floats): the two activation tiles (float4 stores), the
// entropy tile, the parameters (float4 reads).
constexpr int kOffIn = (kPixA + kPixB) * PS;
constexpr int kOffParams = kOffIn + IH * IW;
constexpr int kSmemFloats = kOffParams + kParamsPad;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kOffParams % 4 == 0 && M0 % 4 == 0 && M1 % 4 == 0, "float4 layout");

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Lane i % 32 of B fragment i / 32 of a 3x3 conv k [co][16][3][3], the
// fragments in [chunk][tap][co / 8] order, as ops/tf32.py pack_conv3x3
// packs them: (hi b0, hi b1, lo b0, lo b1) of output channel 8f + g and
// input channels 8 chunk + 2t, + 1.
__device__ float4 b_fragment(const float* __restrict__ k, int nf, int i) {
  const int lane = i & 31, f = (i >> 5) % nf, ct = (i >> 5) / nf;
  const int tap = ct % 9, oc = 8 * f + (lane >> 2), ci = 8 * (ct / 9) + 2 * (lane & 3);
  uint32_t h0, l0, h1, l1;
  split_tf32(k[(oc * 16 + ci) * 9 + tap], h0, l0);
  split_tf32(k[(oc * 16 + ci + 1) * 9 + tap], h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

// The weights as visibility_kernel reads them, from the module's tensors:
// one thread per B fragment lane.
__global__ void pack_kernel(const float* __restrict__ k0, const float* __restrict__ m0,
                            const float* __restrict__ a0, const float* __restrict__ k1,
                            const float* __restrict__ m1, const float* __restrict__ a1,
                            const float* __restrict__ k2, const float* __restrict__ m2,
                            const float* __restrict__ a2, const float* __restrict__ k3,
                            const float* __restrict__ b3, float* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float4* w = reinterpret_cast<float4*>(packed + kParamsPad);
  if (i < kW1) w[i] = b_fragment(k1, 2, i);
  else if (i < kW1 + kW2) w[i] = b_fragment(k2, 1, i - kW1);
  if (i < 144) packed[K0 + i] = k0[(i % 16) * 9 + i / 16];  // [tap][channel]
  if (i < 16) {
    packed[M0 + i] = m0[i];
    packed[A0 + i] = a0[i];
    packed[M1 + i] = m1[i];
    packed[A1 + i] = a1[i];
  }
  if (i < 8) {
    packed[M2 + i] = m2[i];
    packed[A2 + i] = a2[i];
    packed[K3 + i] = k3[i];
  }
  if (i == 0) packed[B3] = b3[0];
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
visibility_kernel(const float* __restrict__ ent,     // [N, H, W]
                  const float* __restrict__ packed,  // [kPacked], from pack_kernel
                  float* __restrict__ out,           // [N, H, W]
                  int H, int W) {
  const float* params = packed;
  const float4* w1 = reinterpret_cast<const float4*>(packed + kParamsPad);
  const float4* w2 = w1 + kW1;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                 // layer-0 output [kPixA][PS]
  float* s_b = smem + kPixA * PS;    // layer-1 output [kPixB][PS]
  float* s_in = smem + kOffIn;       // entropy [IH][IW]
  float* sp = smem + kOffParams;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const float* entn = ent + (size_t)n * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < kParams; i += kThreads) sp[i] = params[i];
  for (int i = tid; i < IH * IW; i += kThreads) {
    const int r = i / IW, c = i - r * IW;
    const int gy = ty0 - 3 + r, gx = tx0 - 3 + c;
    s_in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? entn[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Layer 0: 1 -> 16 channels over the 20 x 20 region; item i forms the
  // channels 8 half .. 8 half + 7 of pixel p.
  for (int i = tid; i < 2 * kPixA; i += kThreads) {
    const int half = i >= kPixA ? 1 : 0, p = i - half * kPixA;
    const int r = p / AW, c = p - r * AW;
    const int gy = ty0 - 2 + r, gx = tx0 - 2 + c;
    float4* dst = reinterpret_cast<float4*>(s_a + p * PS + 8 * half);
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      dst[0] = dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float x = s_in[(r + tap / 3) * IW + c + tap % 3];
      const float4* wk = reinterpret_cast<const float4*>(sp + K0 + tap * 16 + 8 * half);
      const float4 wa = wk[0], wb = wk[1];
      acc[0] += wa.x * x; acc[1] += wa.y * x; acc[2] += wa.z * x; acc[3] += wa.w * x;
      acc[4] += wb.x * x; acc[5] += wb.y * x; acc[6] += wb.z * x; acc[7] += wb.w * x;
    }
    float v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o)
      v[o] = fmaxf(acc[o] * sp[M0 + 8 * half + o] + sp[A0 + 8 * half + o], 0.0f);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // Layer 1: 16 -> 16 channels over the 18 x 18 region, flattened, as an
  // implicit GEMM: MF M fragments of 16 pixels at a time.
  for (int grp = warp; grp < kGroups1; grp += kWarps) {
    // Offsets in s_a of rows g and g + 8 at tap (0, 0) and channel 2t: the
    // region-B pixel (r, c) reads the region-A pixels (r + ky, c + kx). A
    // row past the region reads the last pixel and is not stored.
    int pa[MF][2];
#pragma unroll
    for (int j = 0; j < MF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min((grp * MF + j) * 16 + g + 8 * h, kPixB - 1);
        const int r = p / BW;
        pa[j][h] = (r * AW + p - r * BW) * PS + 2 * t;
      }
    float acc[MF][2][4];
#pragma unroll
    for (int j = 0; j < MF; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][f][e] = 0.0f;
#pragma unroll
    for (int ck = 0; ck < 2; ++ck) {
      float part[MF][2][4];  // one chunk's 72 products, summed from zero
#pragma unroll
      for (int j = 0; j < MF; ++j)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][f][e] = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * AW + tap % 3) * PS + 8 * ck;
        const float4 b0 = __ldg(w1 + ((ck * 9 + tap) * 2) * 32 + lane);
        const float4 b1 = __ldg(w1 + ((ck * 9 + tap) * 2 + 1) * 32 + lane);
#pragma unroll
        for (int j = 0; j < MF; ++j) {
          uint32_t ah[4], al[4];
          split_a(ld2(s_a + pa[j][0] + off), ld2(s_a + pa[j][1] + off), ah, al);
          mma_3xtf32(part[j][0], ah, al, b0);
          mma_3xtf32(part[j][1], ah, al, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < MF; ++j)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][f][e] += part[j][f][e];
    }
    // Epilogue: element 2h + q of N fragment f is pixel row g + 8h, channel
    // 8f + 2t + q.
#pragma unroll
    for (int j = 0; j < MF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (grp * MF + j) * 16 + g + 8 * h;
        if (p >= kPixB) continue;
        const int r = p / BW, c = p - r * BW;
        const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int oc = 8 * f + 2 * t;
          float2 v = make_float2(0.0f, 0.0f);
          if (in) {
            v.x = fmaxf(acc[j][f][2 * h] * sp[M1 + oc] + sp[A1 + oc], 0.0f);
            v.y = fmaxf(acc[j][f][2 * h + 1] * sp[M1 + oc + 1] + sp[A1 + oc + 1], 0.0f);
          }
          *reinterpret_cast<float2*>(s_b + p * PS + oc) = v;
        }
      }
  }
  __syncthreads();

  // Layer 2 (16 -> 8) on the warp's RW tile rows (16 pixels of each, from
  // column c0), then BN, ReLU, the head and the sigmoid from registers.
  const int r0 = RW * (warp / FPR), c0 = 16 * (warp % FPR);
  float acc[RW][4];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float* s_r = s_b + (r0 * BW + c0 + g) * PS + 2 * t;
#pragma unroll
  for (int ck = 0; ck < 2; ++ck) {
    float part[RW][4];
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      // Output row r0 + j at tap (ky, kx) reads layer-1 row R = j + ky:
      // each of the RW + 2 rows is loaded and split at its first use.
      const float* pa = s_r + kx * PS + 8 * ck;
      uint32_t ah[RW + 2][4], al[RW + 2][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float4 b = __ldg(w2 + (ck * 9 + ky * 3 + kx) * 32 + lane);
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const int R = j + ky;
          if (ky == 0 || j == RW - 1) {
            const float* q = pa + R * BW * PS;
            split_a(ld2(q), ld2(q + 8 * PS), ah[R], al[R]);
          }
          mma_3xtf32(part[j], ah[R], al[R], b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  const float m_a = sp[M2 + 2 * t], m_b = sp[M2 + 2 * t + 1];
  const float a_a = sp[A2 + 2 * t], a_b = sp[A2 + 2 * t + 1];
  const float k_a = sp[K3 + 2 * t], k_b = sp[K3 + 2 * t + 1];
  const float b3 = sp[B3];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    // Pixels g (elements 0, 1) and g + 8 (elements 2, 3): this lane's two
    // channels of the head's sum, then the quad's four lanes summed.
    float s0 = fmaxf(acc[j][0] * m_a + a_a, 0.0f) * k_a + fmaxf(acc[j][1] * m_b + a_b, 0.0f) * k_b;
    float s1 = fmaxf(acc[j][2] * m_a + a_a, 0.0f) * k_a + fmaxf(acc[j][3] * m_b + a_b, 0.0f) * k_b;
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const int gy = ty0 + r0 + j, gx = tx0 + c0 + g + 8 * t;  // t = 0 writes pixel g, t = 1 g + 8
    if (t < 2 && gy < H && gx < W) {
      const float logit = (t == 0 ? s0 : s1) + b3;
      out[(size_t)n * H * W + (size_t)gy * W + gx] = 1.0f / (1.0f + expf(-logit));
    }
  }
}

}  // namespace

// Writes the weights of one VisibilityNet, as visibility_net_f32 reads
// them, into packed [visibility_net_packed_floats()].
extern "C" int visibility_net_pack_f32(const float* k0, const float* m0, const float* a0,
                                       const float* k1, const float* m1, const float* a1,
                                       const float* k2, const float* m2, const float* a2,
                                       const float* k3, const float* b3, float* packed,
                                       void* stream) {
  pack_kernel<<<(kW1 + kW2 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, m0, a0, k1, m1, a1, k2, m2, a2, k3, b3, packed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int visibility_net_packed_floats() { return kPacked; }

extern "C" int visibility_net_f32(const float* ent, const float* packed, float* out, int N,
                                  int H, int W, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || (H + TH - 1) / TH > 65535) return -1;
  // Per device and cheap: set on every call so a second GPU is covered too.
  cudaError_t err = cudaFuncSetAttribute(
      visibility_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  visibility_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ent, packed, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel (negative: a CUDA error), for the
// occupancy the design note promises.
extern "C" int visibility_net_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      visibility_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, visibility_kernel, kThreads,
                                                        kSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
