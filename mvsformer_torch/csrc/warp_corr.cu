// K1: plane-sweep warp + group correlation + depth entropy, all source views
// in one launch; and K7, the same warp and correlation without the entropy.
//
// K1 replaces: mvsformer_tpu/ops/pallas/warp_corr.py
// plane_sweep_group_corr_v4_mv (and, at V = 1, plane_sweep_group_corr_v4).
// The contract is the exact, unclipped maths of geometry.homo_warp ->
// correlation.groupwise_correlation -> correlation.entropy_over_depth
// (grid_sample zero padding, align-corners coordinates); the plain version is
// ops/warp_corr.py warp_group_corr_plain. The TPU kernel's band windows and
// its extra zeroing of frustum-OOB pixels are not part of it.
//
// K7 replaces: warp_corr.py plane_sweep_group_corr_v3, the training forward
// (and v1/v2, the same contract with wider bands). It is the same kernel
// body with the entropy compiled out; the plain version is
// warp_corr_fwd_plain.
// The training entropy stays in torch ops on the correlation, where autograd
// sees it. Without the entropy's shared-memory column, D is not bounded.
//
// Bound on the H100: memory. The correlation volume written is V*G*D*H*W
// floats (about 0.9 GB at stage 4 of the DTU eval shape), against ~10*C
// flops per (view, depth, pixel).
//
// Design: one thread per (view, reference pixel), looping over D <= 32.
//  - The relative projection's top three rows come in from the wrapper,
//    computed there in fp32 without TF32; px, py, z are computed here in fp32
//    with the plain version's rounding.
//  - Source features are channels-last, so each bilinear tap is one
//    contiguous C-vector read as float4s; the reference vector sits in
//    registers for the whole depth loop.
//  - The output is [B, V, G, D, H, W]: for a fixed (g, d) neighbouring
//    threads write neighbouring pixels, so every store is coalesced, and the
//    view-weighted sum and Conv3d read it without a transpose.
//  - sum_g corr for each depth is kept in shared memory (one column per
//    thread, no bank conflicts) so the entropy is computed after the loop
//    with the exact two-pass softmax formula -sum p*log(p + 1e-7).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 32;

template <int C, int G, bool kEntropy>
__global__ void __launch_bounds__(kThreads)
warp_group_corr_kernel(const float* __restrict__ ref,  // [B, H, W, C]
                       const float* __restrict__ src,  // [B, V, H, W, C]
                       const float* __restrict__ mat,  // [B, V, 12]
                       const float* __restrict__ dv,   // [B, D, H, W]
                       float* __restrict__ corr,       // [B, V, G, D, H, W]
                       float* __restrict__ ent,        // [B, V, H, W] (K1)
                       int V, int D, int H, int W) {
  constexpr int CG = C / G;
  __shared__ float s_sim[kEntropy ? kMaxD * kThreads : 1];

  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const int bv = b * V + v;
  const int yi = p / W;
  const float fx = (float)(p - yi * W);
  const float fy = (float)yi;

  // Coordinates use explicitly rounded multiplies and adds (no FMA
  // contraction) in the plain version's order, so px, py match it bit for
  // bit: the correlation is steep in px where features change fast.
  const float* M = mat + (size_t)bv * 12;
  const float rx = __fadd_rn(__fadd_rn(__fmul_rn(M[0], fx), __fmul_rn(M[1], fy)), M[2]);
  const float ry = __fadd_rn(__fadd_rn(__fmul_rn(M[4], fx), __fmul_rn(M[5], fy)), M[6]);
  const float rz = __fadd_rn(__fadd_rn(__fmul_rn(M[8], fx), __fmul_rn(M[9], fy)), M[10]);
  const float tx = M[3], ty = M[7], tz = M[11];

  float r[C];
  const float4* ref4 = reinterpret_cast<const float4*>(ref + ((size_t)b * HW + p) * C);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 q = ref4[i];
    r[4 * i + 0] = q.x;
    r[4 * i + 1] = q.y;
    r[4 * i + 2] = q.z;
    r[4 * i + 3] = q.w;
  }

  const float* srcv = src + (size_t)bv * HW * C;
  const float* dvp = dv + (size_t)b * D * HW + p;
  float* corrp = corr + (size_t)bv * G * D * HW + p;
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);

  for (int d = 0; d < D; ++d) {
    const float depth = dvp[(size_t)d * HW];
    const float X = __fadd_rn(__fmul_rn(rx, depth), tx);
    const float Y = __fadd_rn(__fmul_rn(ry, depth), ty);
    const float Z = __fadd_rn(__fmul_rn(rz, depth), tz);
    const float sx = __fdiv_rn(X, __fadd_rn(Z, 1e-6f));
    const float sy = __fdiv_rn(Y, __fadd_rn(Z, 1e-6f));
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float wx = sx - x0;
    const float wy = sy - y0;
    const float x1 = x0 + 1.0f;
    const float y1 = y0 + 1.0f;
    // Validity is tested on the float coordinates, before any conversion to
    // int, so far-away projections never overflow an index.
    const float vx0 = (x0 >= 0.0f && x0 <= wmax) ? 1.0f : 0.0f;
    const float vx1 = (x1 >= 0.0f && x1 <= wmax) ? 1.0f : 0.0f;
    const float vy0 = (y0 >= 0.0f && y0 <= hmax) ? 1.0f : 0.0f;
    const float vy1 = (y1 >= 0.0f && y1 <= hmax) ? 1.0f : 0.0f;
    const float w00 = (1.0f - wx) * (1.0f - wy) * (vx0 * vy0);
    const float w01 = wx * (1.0f - wy) * (vx1 * vy0);
    const float w10 = (1.0f - wx) * wy * (vx0 * vy1);
    const float w11 = wx * wy * (vx1 * vy1);
    // Invalid taps read a clamped in-image address with weight 0.
    const int ix0 = (int)fminf(fmaxf(x0, 0.0f), wmax);
    const int ix1 = (int)fminf(fmaxf(x1, 0.0f), wmax);
    const int iy0 = (int)fminf(fmaxf(y0, 0.0f), hmax);
    const int iy1 = (int)fminf(fmaxf(y1, 0.0f), hmax);
    const float4* t00 = reinterpret_cast<const float4*>(srcv + ((size_t)iy0 * W + ix0) * C);
    const float4* t01 = reinterpret_cast<const float4*>(srcv + ((size_t)iy0 * W + ix1) * C);
    const float4* t10 = reinterpret_cast<const float4*>(srcv + ((size_t)iy1 * W + ix0) * C);
    const float4* t11 = reinterpret_cast<const float4*>(srcv + ((size_t)iy1 * W + ix1) * C);

    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 a = __ldg(t00 + i);
      const float4 e = __ldg(t01 + i);
      const float4 c = __ldg(t10 + i);
      const float4 f = __ldg(t11 + i);
      const float o0 = a.x * w00 + e.x * w01 + c.x * w10 + f.x * w11;
      const float o1 = a.y * w00 + e.y * w01 + c.y * w10 + f.y * w11;
      const float o2 = a.z * w00 + e.z * w01 + c.z * w10 + f.z * w11;
      const float o3 = a.w * w00 + e.w * w01 + c.w * w10 + f.w * w11;
      acc[(4 * i + 0) / CG] += r[4 * i + 0] * o0;
      acc[(4 * i + 1) / CG] += r[4 * i + 1] * o1;
      acc[(4 * i + 2) / CG] += r[4 * i + 2] * o2;
      acc[(4 * i + 3) / CG] += r[4 * i + 3] * o3;
    }
    float sim = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float cg = acc[g] / (float)CG;
      corrp[((size_t)g * D + d) * HW] = cg;
      sim += cg;
    }
    if (kEntropy) s_sim[d * kThreads + threadIdx.x] = sim;
  }
  if (!kEntropy) return;

  // Entropy over D of softmax(sim): the same two-pass formula as the plain
  // version. Each thread reads back only its own column of s_sim.
  float m = -INFINITY;
  for (int d = 0; d < D; ++d) m = fmaxf(m, s_sim[d * kThreads + threadIdx.x]);
  float z = 0.0f;
  for (int d = 0; d < D; ++d) z += expf(s_sim[d * kThreads + threadIdx.x] - m);
  float h = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float pr = expf(s_sim[d * kThreads + threadIdx.x] - m) / z;
    h += pr * logf(pr + 1e-7f);
  }
  ent[(size_t)bv * HW + p] = -h;
}

template <int C, bool kEntropy>
void launch(const float* ref, const float* src, const float* mat, const float* dv,
            float* corr, float* ent, int B, int V, int D, int H, int W,
            cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, V, B);
  warp_group_corr_kernel<C, 8, kEntropy><<<grid, kThreads, 0, stream>>>(
      ref, src, mat, dv, corr, ent, V, D, H, W);
}

template <bool kEntropy>
int dispatch(const float* ref, const float* src, const float* mat, const float* dv,
             float* corr, float* ent, int B, int V, int D, int H, int W, int C, int G,
             void* stream) {
  if (D < 1 || (kEntropy && D > kMaxD) || G != 8 || B < 1 || B > 65535 || V < 1 ||
      V > 65535 || H < 1 || W < 1) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: launch<8, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s); break;
    case 16: launch<16, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s); break;
    case 32: launch<32, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s); break;
    case 64: launch<64, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: corr and entropy.
extern "C" int warp_group_corr_f32(const float* ref, const float* src, const float* mat,
                                   const float* dv, float* corr, float* ent, int B, int V,
                                   int D, int H, int W, int C, int G, void* stream) {
  return dispatch<true>(ref, src, mat, dv, corr, ent, B, V, D, H, W, C, G, stream);
}

// K7: corr only.
extern "C" int warp_corr_fwd_f32(const float* ref, const float* src, const float* mat,
                                 const float* dv, float* corr, int B, int V, int D, int H,
                                 int W, int C, int G, void* stream) {
  return dispatch<false>(ref, src, mat, dv, corr, nullptr, B, V, D, H, W, C, G, stream);
}
