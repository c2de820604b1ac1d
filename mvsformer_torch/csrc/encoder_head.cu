// K4: the FPN encoder head, conv00 -> conv01 -> downsample1, in one launch.
//
// Replaces: mvsformer_tpu/ops/pallas/encoder_head.py encoder_head. Contract:
// FPNEncoder's first three ConvNormAct layers (models/fpn.py), each a conv
// without bias, folded BN and leaky-ReLU 0.1:
//   conv00 = 7x7, 3 -> 8;  conv01 = 5x5, 8 -> 8;  down0 = 5x5 stride 2, 8 -> 16.
// imgs [N,3,H,W] -> conv01 [N,8,H,W] and down0 [N,16,ceil(H/2),ceil(W/2)].
// The plain version is ops/encoder_head.py encoder_head_plain.
//
// Bound on the H100: operations. 2 * (7*7*3*8 + 5*5*8*8 + 5*5*8*16/4) =
// 7152 flop per full-resolution pixel in fp32 CUDA cores, against 60 bytes of
// HBM traffic per pixel (3 channels read, 8 + 16/4 written). The 8-channel
// conv00 map, which a layer-by-layer version writes and reads back, never
// reaches device memory.
//
// Design: one block per 16 x 32 tile of conv01.
//  - The image tile with a 7-pixel halo, conv00 with a 4-pixel halo and
//    conv01 with a 2-pixel halo all live in dynamic shared memory (~94 KB,
//    so two blocks fit on an SM), with every weight.
//  - Zero padding applies at the IMAGE border at every layer: halo positions
//    outside the image are written as exact zeros, never computed from the
//    layer below (lrelu(BN(conv(0))) is not zero).
//  - Register blocking: a thread computes 4 neighbouring pixels x 8 output
//    channels (conv00, conv01) or 1 pixel x 8 of the 16 channels (down0). Per
//    input row it loads the activations it needs once and reuses them across
//    the kernel's x taps; weights are stored [ci][ky][kx][o], so a tap's 8
//    output channels are two float4 broadcast loads for 32 (or 8) FMAs.
//  - conv01's interior goes to device memory from shared memory in a
//    separate coalesced loop; down0 is written straight from registers.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 16, TW = 32;            // conv01 output tile
constexpr int IH = TH + 14, IW = TW + 14;  // image tile (7-pixel halo)
constexpr int AH = TH + 8, AW = TW + 8;    // conv00 tile (4-pixel halo)
constexpr int BH = TH + 4, BW = TW + 4;    // conv01 tile (2-pixel halo)
constexpr int DH = TH / 2, DW = TW / 2;    // down0 tile

// Packed parameter layout (floats), built by the Python wrapper. Every
// offset is a multiple of 4, so float4 reads stay aligned.
constexpr int K00 = 0;                 // [3][7][7][8]
constexpr int M00 = K00 + 3 * 49 * 8;  // [8] folded BN scale
constexpr int A00 = M00 + 8;           // [8] folded BN shift
constexpr int K01 = A00 + 8;           // [8][5][5][8]
constexpr int M01 = K01 + 8 * 25 * 8;
constexpr int A01 = M01 + 8;
constexpr int KD = A01 + 8;            // [8][5][5][16]
constexpr int MD = KD + 8 * 25 * 16;
constexpr int AD = MD + 16;
constexpr int kParams = AD + 16;
static_assert(kParams % 4 == 0, "packed parameters must stay float4-aligned");

constexpr int kImg = kParams;            // [3][IH][IW]
constexpr int kA = kImg + 3 * IH * IW;   // [8][AH][AW]
constexpr int kB = kA + 8 * AH * AW;     // [8][BH][BW]
constexpr int kSmemFloats = kB + 8 * BH * BW;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float lrelu(float x) { return fmaxf(x, 0.1f * x); }

__device__ __forceinline__ void fma8(float* acc, const float* w, float x) {
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
  acc[0] += w0.x * x; acc[1] += w0.y * x; acc[2] += w0.z * x; acc[3] += w0.w * x;
  acc[4] += w1.x * x; acc[5] += w1.y * x; acc[6] += w1.z * x; acc[7] += w1.w * x;
}

// A stride-1 KxK conv CIN -> 8 over an RH x RW region of a shared-memory
// source (row stride SW, plane SH*SW), 4 pixels per item; writes the folded,
// activated result into dst (row stride RW), zero outside the image.
template <int CIN, int K, int RH, int RW, int SH, int SW>
__device__ __forceinline__ void conv_to_smem(const float* __restrict__ src,
                                             const float* __restrict__ sp, int kw, int km,
                                             int ka, float* __restrict__ dst, int gy0,
                                             int gx0, int H, int W) {
  static_assert(RW % 4 == 0, "region width must be a multiple of 4");
  constexpr int G = RW / 4;
  for (int it = threadIdx.x; it < RH * G; it += kThreads) {
    const int r = it / G, c0 = (it - r * G) * 4;
    float acc[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[p][o] = 0.0f;
    for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* row = src + ci * SH * SW + (r + ky) * SW + c0;
        float x[K + 3];
#pragma unroll
        for (int j = 0; j < K + 3; ++j) x[j] = row[j];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float* w = sp + kw + ((ci * K + ky) * K + kx) * 8;
#pragma unroll
          for (int p = 0; p < 4; ++p) fma8(acc[p], w, x[p + kx]);
        }
      }
    }
    const int gy = gy0 + r;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int gx = gx0 + c0 + p;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int o = 0; o < 8; ++o)
        dst[o * RH * RW + r * RW + c0 + p] =
            in ? lrelu(acc[p][o] * sp[km + o] + sp[ka + o]) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
encoder_head_kernel(const float* __restrict__ imgs,    // [N, 3, H, W]
                    const float* __restrict__ params,  // [kParams]
                    float* __restrict__ conv01,        // [N, 8, H, W]
                    float* __restrict__ down0,         // [N, 16, Ho, Wo]
                    int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;
  float* s_img = smem + kImg;
  float* s_a = smem + kA;
  float* s_b = smem + kB;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t HW = (size_t)H * W;

  for (int i = tid; i < kParams / 4; i += kThreads)
    reinterpret_cast<float4*>(sp)[i] = reinterpret_cast<const float4*>(params)[i];
  for (int i = tid; i < 3 * IH * IW; i += kThreads) {
    const int ci = i / (IH * IW), rc = i - ci * (IH * IW);
    const int r = rc / IW, c = rc - r * IW;
    const int gy = ty0 - 7 + r, gx = tx0 - 7 + c;
    s_img[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? imgs[((size_t)n * 3 + ci) * HW + (size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // conv00 over the tile with a 4-pixel halo.
  conv_to_smem<3, 7, AH, AW, IH, IW>(s_img, sp, K00, M00, A00, s_a, ty0 - 4, tx0 - 4, H, W);
  __syncthreads();
  // conv01 over the tile with a 2-pixel halo.
  conv_to_smem<8, 5, BH, BW, AH, AW>(s_a, sp, K01, M01, A01, s_b, ty0 - 2, tx0 - 2, H, W);
  __syncthreads();

  // conv01's interior to device memory, coalesced along W.
  for (int i = tid; i < 8 * TH * TW; i += kThreads) {
    const int o = i / (TH * TW), rc = i - o * (TH * TW);
    const int r = rc / TW, c = rc - r * TW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy < H && gx < W)
      conv01[((size_t)n * 8 + o) * HW + (size_t)gy * W + gx] =
          s_b[o * BH * BW + (r + 2) * BW + c + 2];
  }

  // down0: 5x5 stride 2 over conv01, one pixel x 8 of the 16 channels.
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  for (int it = tid; it < 2 * DH * DW; it += kThreads) {
    const int half = it / (DH * DW), rc = it - half * (DH * DW);
    const int r = rc / DW, c = rc - r * DW;
    const int oy = ty0 / 2 + r, ox = tx0 / 2 + c;
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
    // Output (oy, ox) reads conv01 rows 2oy-2..2oy+2, which sit at tile
    // rows 2r..2r+4 (the tile starts at ty0 - 2); columns likewise.
    for (int ci = 0; ci < 8; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 5; ++ky) {
        const float* row = s_b + ci * BH * BW + (2 * r + ky) * BW + 2 * c;
#pragma unroll
        for (int kx = 0; kx < 5; ++kx)
          fma8(acc, sp + KD + ((ci * 5 + ky) * 5 + kx) * 16 + half * 8, row[kx]);
      }
    }
    if (oy < Ho && ox < Wo) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int oc = half * 8 + o;
        down0[((size_t)n * 16 + oc) * Ho * Wo + (size_t)oy * Wo + ox] =
            lrelu(acc[o] * sp[MD + oc] + sp[AD + oc]);
      }
    }
  }
}

}  // namespace

extern "C" int encoder_head_f32(const float* imgs, const float* params, float* conv01,
                                float* down0, int N, int H, int W, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || (H + TH - 1) / TH > 65535) return -1;
  // Per device and cheap: set on every call so a second GPU is covered too.
  cudaError_t err = cudaFuncSetAttribute(
      encoder_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  encoder_head_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      imgs, params, conv01, down0, H, W);
  return static_cast<int>(cudaGetLastError());
}
