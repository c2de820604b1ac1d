// K2: the visibility CNN, entropy map -> per-pixel view weight, in one launch.
//
// Replaces: mvsformer_tpu/ops/pallas/vis_net.py fused_visibility. Contract:
// the flax VisibilityNet eval path (models/stagenet.py) = three
// [3x3 conv (no bias), folded BN, ReLU] layers 1 -> 16 -> 16 -> 8, a 1x1 conv
// 8 -> 1 with bias, and a sigmoid. The plain version is ops/vis_net.py
// visibility_net_plain; the wrapper folds BN into (mul, add) in fp32.
//
// Bound on the H100: operations. About 7.2 kflop per output pixel in fp32
// CUDA cores against 8 bytes of HBM traffic per pixel (one entropy read, one
// weight write): the 16/16/8-channel full-resolution activations are what a
// layer-by-layer version would move, and this kernel never writes them.
//
// Design: one block per 16 x 32 output tile.
//  - The entropy tile with a 3-pixel halo, the layer-0 output (16 channels,
//    2-pixel halo) and the layer-1 output (16 channels, 1-pixel halo) all
//    live in dynamic shared memory (~100 KB, above the 48 KB default, so
//    the launcher raises cudaFuncAttributeMaxDynamicSharedMemorySize).
//  - All weights sit in shared memory too; every thread of a warp reads the
//    same weight at the same time (a broadcast) and neighbouring activations
//    (no bank conflicts).
//  - Zero padding applies at the IMAGE border at every layer: halo positions
//    outside the image are written as exact zeros, never computed from the
//    layer below (relu(BN(conv(0))) is not zero).
//  - Layer 2, the 1x1 head and the sigmoid run in registers and write the
//    output directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 16, TW = 32;          // output tile
constexpr int IH = TH + 6, IW = TW + 6;  // entropy tile (3-pixel halo)
constexpr int AH = TH + 4, AW = TW + 4;  // layer-0 output (2-pixel halo)
constexpr int BH = TH + 2, BW = TW + 2;  // layer-1 output (1-pixel halo)

// Packed parameter layout (floats), built by the Python wrapper.
constexpr int K0 = 0;               // [16][1][3][3]
constexpr int M0 = K0 + 16 * 9;     // [16] folded BN scale
constexpr int A0 = M0 + 16;         // [16] folded BN shift
constexpr int K1 = A0 + 16;         // [16][16][3][3]
constexpr int M1 = K1 + 16 * 16 * 9;
constexpr int A1 = M1 + 16;
constexpr int K2 = A1 + 16;         // [8][16][3][3]
constexpr int M2 = K2 + 8 * 16 * 9;
constexpr int A2 = M2 + 8;
constexpr int K3 = A2 + 8;          // [8]
constexpr int B3 = K3 + 8;          // [1]
constexpr int kParams = B3 + 1;
constexpr int kParamsPad = (kParams + 3) / 4 * 4;

constexpr int kSmemFloats = kParamsPad + IH * IW + 16 * AH * AW + 16 * BH * BW;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__global__ void __launch_bounds__(kThreads)
visibility_kernel(const float* __restrict__ ent,     // [N, H, W]
                  const float* __restrict__ params,  // [kParams]
                  float* __restrict__ out,           // [N, H, W]
                  int H, int W) {
  extern __shared__ float smem[];
  float* sp = smem;
  float* s_in = sp + kParamsPad;
  float* s_a = s_in + IH * IW;
  float* s_b = s_a + 16 * AH * AW;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const float* entn = ent + (size_t)n * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < kParams; i += kThreads) sp[i] = params[i];
  for (int i = tid; i < IH * IW; i += kThreads) {
    const int r = i / IW, c = i - (i / IW) * IW;
    const int gy = ty0 - 3 + r, gx = tx0 - 3 + c;
    s_in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? entn[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // Layer 0: 1 -> 16 channels over the (TH+4) x (TW+4) region.
  for (int i = tid; i < AH * AW; i += kThreads) {
    const int r = i / AW, c = i - (i / AW) * AW;
    const int gy = ty0 - 2 + r, gx = tx0 - 2 + c;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int o = 0; o < 16; ++o) s_a[o * AH * AW + i] = 0.0f;
      continue;
    }
    float x[9];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) x[ky * 3 + kx] = s_in[(r + ky) * IW + c + kx];
#pragma unroll
    for (int o = 0; o < 16; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc += sp[K0 + o * 9 + t] * x[t];
      s_a[o * AH * AW + i] = fmaxf(acc * sp[M0 + o] + sp[A0 + o], 0.0f);
    }
  }
  __syncthreads();

  // Layer 1: 16 -> 16 channels over the (TH+2) x (TW+2) region.
  for (int i = tid; i < BH * BW; i += kThreads) {
    const int r = i / BW, c = i - (i / BW) * BW;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int o = 0; o < 16; ++o) s_b[o * BH * BW + i] = 0.0f;
      continue;
    }
    float acc[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) acc[o] = 0.0f;
    for (int ci = 0; ci < 16; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float xv = s_a[ci * AH * AW + (r + ky) * AW + c + kx];
#pragma unroll
          for (int o = 0; o < 16; ++o)
            acc[o] += sp[K1 + ((o * 16 + ci) * 3 + ky) * 3 + kx] * xv;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 16; ++o)
      s_b[o * BH * BW + i] = fmaxf(acc[o] * sp[M1 + o] + sp[A1 + o], 0.0f);
  }
  __syncthreads();

  // Layer 2 (16 -> 8), the 1x1 head (8 -> 1, bias) and the sigmoid.
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int r = i / TW, c = i - (i / TW) * TW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= H || gx >= W) continue;
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
    for (int ci = 0; ci < 16; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float xv = s_b[ci * BH * BW + (r + ky) * BW + c + kx];
#pragma unroll
          for (int o = 0; o < 8; ++o)
            acc[o] += sp[K2 + ((o * 16 + ci) * 3 + ky) * 3 + kx] * xv;
        }
      }
    }
    float logit = 0.0f;
#pragma unroll
    for (int o = 0; o < 8; ++o)
      logit += fmaxf(acc[o] * sp[M2 + o] + sp[A2 + o], 0.0f) * sp[K3 + o];
    logit += sp[B3];
    out[(size_t)n * H * W + (size_t)gy * W + gx] = 1.0f / (1.0f + expf(-logit));
  }
}

}  // namespace

extern "C" int visibility_net_f32(const float* ent, const float* params, float* out,
                                  int N, int H, int W, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || (H + TH - 1) / TH > 65535) return -1;
  // Per device and cheap: set on every call so a second GPU is covered too.
  cudaError_t err = cudaFuncSetAttribute(
      visibility_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  visibility_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ent, params, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
