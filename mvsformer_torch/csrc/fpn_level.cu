// K5: one top-down FPN level in one launch.
//
// Replaces: mvsformer_tpu/ops/pallas/fpn_final.py fpn_level (and
// fpn_final_level) and mvsformer_tpu/ops/pallas/fpn_up.py fpn_up_level.
// Contract: one level of FPNDecoder (models/fpn.py),
//   intra' = up2(intra_prev) + conv1x1(lateral) + b1          [N,64,2h,2w]
//   out    = swish(BN(conv3x3(intra') + b3))                  [N,CO,2h,2w]
// with up2 the 2x bilinear resize, align_corners=True, and the 3x3 conv
// zero-padded at the image border of intra'. intra' is written only when
// the caller asks for it (the next level reads it). The plain version is
// ops/fpn_level.py fpn_level_plain.
//
// Bound on the H100: operations. Per output pixel 2 * 64 * (CL + 9 * CO)
// flop in fp32 CUDA cores (5120 at the final level, CL = CO = 8) against
// 4 * (64 / 4 + CL + CO) bytes (+256 with intra'): the 64-channel intra',
// up2(intra_prev) and conv1x1(lateral), which the plain version writes at
// full resolution, never reach device memory unless intra' is asked for.
//
// Design: one block per 16 x 16 output tile, for all CO channels.
//  - Phase 1 computes intra' over the tile with a 1-pixel halo, 64
//    channels, into dynamic shared memory (64 x 18 x 18 floats, 83 KB);
//    positions outside the image are exact zeros: the 3x3 conv pads
//    intra', not intra_prev. The align-corners source coordinate and its
//    weight are computed as PyTorch's upsample_bilinear2d computes them
//    (scale = float(h-1) / (2h-1), src = scale * i, truncated), so the
//    kernel and the plain version interpolate with the same weights.
//  - Phase 2 runs the 3x3 conv from shared memory. A thread computes 4
//    neighbouring pixels x 8 output channels over 64 / KS input channels;
//    with CO < 32 the input channels are split KS = 32 / CO ways so that
//    all 256 threads work, and the partial sums meet in shared memory.
//    Weights sit in shared memory as [ci][ky][kx][o]: a tap's 8 channels
//    are two float4 broadcast loads for 32 FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 16, TW = 16;           // output tile
constexpr int SH = TH + 2, SW = TW + 2;   // intra' tile (1-pixel halo)
constexpr int kPlane = SH * SW;

template <int CL, int CO>
struct Level {
  // Packed parameter layout (floats), built by the Python wrapper.
  static constexpr int W1 = 0;              // [64][CL]
  static constexpr int B1 = W1 + 64 * CL;   // [64]
  static constexpr int K3 = B1 + 64;        // [64][3][3][CO]
  static constexpr int B3 = K3 + 576 * CO;  // [CO]
  static constexpr int MU = B3 + CO;        // [CO] folded BN scale
  static constexpr int AD = MU + CO;        // [CO] folded BN shift
  static constexpr int kParams = AD + CO;
  static constexpr int KS = 32 / CO;        // input-channel split of the 3x3 conv
  static constexpr size_t kSmemBytes = sizeof(float) * (kParams + 64 * kPlane);
  static_assert(CL % 4 == 0 && CO % 8 == 0 && kParams % 4 == 0, "float4 layout");
  static_assert((TH * TW / 4) * (CO / 8) * KS == kThreads, "one item per thread");
};

__device__ __forceinline__ void fma8(float* acc, const float* w, float x) {
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
  acc[0] += w0.x * x; acc[1] += w0.y * x; acc[2] += w0.z * x; acc[3] += w0.w * x;
  acc[4] += w1.x * x; acc[5] += w1.y * x; acc[6] += w1.z * x; acc[7] += w1.w * x;
}

template <int CL, int CO>
__global__ void __launch_bounds__(kThreads)
fpn_level_kernel(const float* __restrict__ prev,    // [N, 64, h, w]
                 const float* __restrict__ lat,     // [N, CL, 2h, 2w]
                 const float* __restrict__ params,  // [Level::kParams]
                 float* __restrict__ out,           // [N, CO, 2h, 2w]
                 float* __restrict__ intra_out,     // [N, 64, 2h, 2w] or null
                 int h, int w, float rh, float rw) {
  using L = Level<CL, CO>;
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;
  float* s_i = smem + L::kParams;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int H = 2 * h, W = 2 * w;
  const size_t HW = (size_t)H * W, hw = (size_t)h * w;

  for (int i = tid; i < L::kParams / 4; i += kThreads)
    reinterpret_cast<float4*>(sp)[i] = reinterpret_cast<const float4*>(params)[i];
  __syncthreads();

  // Phase 1: intra' over the tile with a 1-pixel halo; item = (pixel,
  // quarter of the 64 channels).
  for (int it = tid; it < 4 * kPlane; it += kThreads) {
    const int q = it / kPlane, rc = it - q * kPlane;
    const int r = rc / SW, c = rc - r * SW;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    float* dst = s_i + q * 16 * kPlane + rc;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j * kPlane] = 0.0f;
      continue;
    }
    const float sy = __fmul_rn(rh, (float)gy);
    const int y0 = (int)sy;
    const size_t dy = y0 < h - 1 ? (size_t)w : 0;
    const float ly1 = __fsub_rn(sy, (float)y0), ly0 = __fsub_rn(1.0f, ly1);
    const float sx = __fmul_rn(rw, (float)gx);
    const int x0 = (int)sx;
    const int dx = x0 < w - 1 ? 1 : 0;
    const float lx1 = __fsub_rn(sx, (float)x0), lx0 = __fsub_rn(1.0f, lx1);

    float l[CL];
#pragma unroll
    for (int j = 0; j < CL; ++j) l[j] = lat[((size_t)n * CL + j) * HW + (size_t)gy * W + gx];
    const bool emit = intra_out != nullptr && r >= 1 && r <= TH && c >= 1 && c <= TW;
    const float* p00 = prev + (size_t)n * 64 * hw + (size_t)y0 * w + x0;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int ch = q * 16 + j;
      const float* pc = p00 + ch * hw;
      const float up = ly0 * (lx0 * pc[0] + lx1 * pc[dx]) + ly1 * (lx0 * pc[dy] + lx1 * pc[dy + dx]);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < CL; k += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(sp + L::W1 + ch * CL + k);
        acc += wv.x * l[k] + wv.y * l[k + 1] + wv.z * l[k + 2] + wv.w * l[k + 3];
      }
      const float v = up + (acc + sp[L::B1 + ch]);
      dst[j * kPlane] = v;
      if (emit) intra_out[((size_t)n * 64 + ch) * HW + (size_t)gy * W + gx] = v;
    }
  }
  __syncthreads();

  // Phase 2: the 3x3 conv; item = (4-pixel group, 8 output channels,
  // 64 / KS input channels).
  constexpr int NPG = TH * TW / 4, NOG = CO / 8, KS = L::KS, CPS = 64 / KS;
  const int pg = tid % NPG, og = (tid / NPG) % NOG, ks = tid / (NPG * NOG);
  const int r = pg / (TW / 4), c0 = (pg % (TW / 4)) * 4;
  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[p][o] = 0.0f;
  for (int ci = ks * CPS; ci < (ks + 1) * CPS; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* row = s_i + ci * kPlane + (r + ky) * SW + c0;
      float x[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) x[j] = row[j];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wp = sp + L::K3 + ((ci * 3 + ky) * 3 + kx) * CO + og * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) fma8(acc[p], wp, x[p + kx]);
      }
    }
  }
  if (KS > 1) {
    // The split's partial sums meet in shared memory (s_i is free now).
    constexpr int NI = NPG * NOG;
    const int item = tid % NI;
    __syncthreads();
    if (ks > 0)
#pragma unroll
      for (int j = 0; j < 32; ++j) s_i[(j * (KS - 1) + ks - 1) * NI + item] = acc[j / 8][j % 8];
    __syncthreads();
    if (ks == 0)
      for (int s = 1; s < KS; ++s)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j / 8][j % 8] += s_i[(j * (KS - 1) + s - 1) * NI + item];
  }
  if (ks != 0) return;

  const int gy = ty0 + r, gx = tx0 + c0;
  if (gy >= H || gx >= W) return;
  float y[4][8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int oc = og * 8 + o;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float t = (acc[p][o] + sp[L::B3 + oc]) * sp[L::MU + oc] + sp[L::AD + oc];
      y[p][o] = t * (1.0f / (1.0f + expf(-t)));  // swish, as x * sigmoid(x)
    }
  }
  const bool vec = (W % 4 == 0) && gx + 3 < W;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float* dst = out + ((size_t)n * CO + og * 8 + o) * HW + (size_t)gy * W + gx;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0][o], y[1][o], y[2][o], y[3][o]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (gx + p < W) dst[p] = y[p][o];
    }
  }
}

template <int CL, int CO>
int launch(const float* prev, const float* lat, const float* params, float* out,
           float* intra_out, int N, int h, int w, cudaStream_t stream) {
  using L = Level<CL, CO>;
  // Per device and cheap: set on every call so a second GPU is covered too.
  cudaError_t err = cudaFuncSetAttribute(fpn_level_kernel<CL, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H = 2 * h, W = 2 * w;
  // The align-corners scale as PyTorch computes it: float(in - 1) / (out - 1).
  const float rh = (float)(h - 1) / (float)(H - 1);
  const float rw = (float)(w - 1) / (float)(W - 1);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  fpn_level_kernel<CL, CO><<<grid, kThreads, L::kSmemBytes, stream>>>(
      prev, lat, params, out, intra_out, h, w, rh, rw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fpn_level_f32(const float* prev, const float* lat, const float* params,
                             float* out, float* intra_out, int N, int h, int w, int cl,
                             int co, void* stream) {
  if (N < 1 || N > 65535 || h < 1 || w < 1 || (2 * h + TH - 1) / TH > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cl == 32 && co == 32) return launch<32, 32>(prev, lat, params, out, intra_out, N, h, w, s);
  if (cl == 16 && co == 16) return launch<16, 16>(prev, lat, params, out, intra_out, N, h, w, s);
  if (cl == 8 && co == 8) return launch<8, 8>(prev, lat, params, out, intra_out, N, h, w, s);
  return -1;
}
