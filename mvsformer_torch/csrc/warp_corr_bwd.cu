// K8: the backward of the plane-sweep warp + group correlation (K7), for the
// reference and source features, all source views in one launch.
//
// Replaces: mvsformer_tpu/ops/pallas/warp_corr_bwd.py
// plane_sweep_group_corr_bwd. The contract is the exact VJP of the unclipped
// forward geometry.homo_warp -> correlation.groupwise_correlation (the JAX
// package's native_bwd=False branch, warp_corr_train.py:107-117), in the
// feature arguments only: the coordinates carry no gradient. With
//   corr[v,g,d,p] = (1/CG) sum_{c in g} ref[p,c] * warped[v,d,p,c]
//   warped[v,d,p,c] = sum_taps w_tap(v,d,p) * src[v, tap, c]
// and dcex[v,d,p,c] = dcorr[v,g(c),d,p] / CG:
//   dref[p,c]      = sum_v sum_d dcex[v,d,p,c] * warped[v,d,p,c]
//   dsrc[v,q,c]    = sum over the (d, p) whose bilinear taps include q of
//                    w_tap * ref[p,c] * dcex[v,d,p,c]
// Taps outside the image contribute nothing, as in geometry.bilinear_sample.
// The plain version is ops/warp_corr_train.py warp_corr_bwd_plain: autograd
// through the plain forward.
//
// Bound on the H100: memory, with the scatter's atomics on top. It reads
// dcorr (B*V*G*D*H*W floats, as large as the forward's output) once, and
// the taps of src once per depth, like the forward.
//
// Design: one thread per (batch, view, reference pixel), looping over D, as
// K7 does.
//  - px, py, z and the tap weights are recomputed with K7's explicitly
//    rounded operations in K7's order, so the taps are the forward's to the
//    last bit. The warped volume is never stored: each thread re-reads its
//    four source taps per depth.
//  - dref: the thread keeps its pixel's C sums in registers over D, then adds
//    them into dref with one atomicAdd per channel (V threads share a pixel).
//  - dsrc: the scatter is an fp32 atomicAdd per (tap, channel) into dsrc,
//    which the wrapper zeroes first. Neighbouring reference pixels hit
//    neighbouring taps, so the atomics stay in L2.
//  The atomics make the order of every sum, and so its last bits, vary from
//  run to run: compare dref and dsrc with a tolerance relative to their
//  scale, never bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

template <int C, int G>
__global__ void __launch_bounds__(kThreads)
warp_corr_bwd_kernel(const float* __restrict__ ref,    // [B, H, W, C]
                     const float* __restrict__ src,    // [B, V, H, W, C]
                     const float* __restrict__ mat,    // [B, V, 12]
                     const float* __restrict__ dv,     // [B, D, H, W]
                     const float* __restrict__ dcorr,  // [B, V, G, D, H, W]
                     float* __restrict__ dref,         // [B, H, W, C], zeroed
                     float* __restrict__ dsrc,         // [B, V, H, W, C], zeroed
                     int V, int D, int H, int W) {
  constexpr int CG = C / G;
  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const int bv = b * V + v;
  const int yi = p / W;
  const float fx = (float)(p - yi * W);
  const float fy = (float)yi;

  // K7's coordinates, operation for operation (see csrc/warp_corr.cu).
  const float* M = mat + (size_t)bv * 12;
  const float rx = __fadd_rn(__fadd_rn(__fmul_rn(M[0], fx), __fmul_rn(M[1], fy)), M[2]);
  const float ry = __fadd_rn(__fadd_rn(__fmul_rn(M[4], fx), __fmul_rn(M[5], fy)), M[6]);
  const float rz = __fadd_rn(__fadd_rn(__fmul_rn(M[8], fx), __fmul_rn(M[9], fy)), M[10]);
  const float tx = M[3], ty = M[7], tz = M[11];

  float r[C];
  float dr[C];
  const float4* ref4 = reinterpret_cast<const float4*>(ref + ((size_t)b * HW + p) * C);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 q = ref4[i];
    r[4 * i + 0] = q.x;
    r[4 * i + 1] = q.y;
    r[4 * i + 2] = q.z;
    r[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dr[c] = 0.0f;

  const float* srcv = src + (size_t)bv * HW * C;
  float* dsrcv = dsrc + (size_t)bv * HW * C;
  const float* dvp = dv + (size_t)b * D * HW + p;
  const float* dcp = dcorr + (size_t)bv * G * D * HW + p;
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
    const bool bx0 = x0 >= 0.0f && x0 <= wmax;
    const bool bx1 = x1 >= 0.0f && x1 <= wmax;
    const bool by0 = y0 >= 0.0f && y0 <= hmax;
    const bool by1 = y1 >= 0.0f && y1 <= hmax;
    const float w00 = (1.0f - wx) * (1.0f - wy) * ((bx0 && by0) ? 1.0f : 0.0f);
    const float w01 = wx * (1.0f - wy) * ((bx1 && by0) ? 1.0f : 0.0f);
    const float w10 = (1.0f - wx) * wy * ((bx0 && by1) ? 1.0f : 0.0f);
    const float w11 = wx * wy * ((bx1 && by1) ? 1.0f : 0.0f);
    const int ix0 = (int)fminf(fmaxf(x0, 0.0f), wmax);
    const int ix1 = (int)fminf(fmaxf(x1, 0.0f), wmax);
    const int iy0 = (int)fminf(fmaxf(y0, 0.0f), hmax);
    const int iy1 = (int)fminf(fmaxf(y1, 0.0f), hmax);
    const size_t o00 = ((size_t)iy0 * W + ix0) * C;
    const size_t o01 = ((size_t)iy0 * W + ix1) * C;
    const size_t o10 = ((size_t)iy1 * W + ix0) * C;
    const size_t o11 = ((size_t)iy1 * W + ix1) * C;

    float e[G];
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] = dcp[((size_t)g * D + d) * HW] / (float)CG;

    // dref: the warped vector, as K7 forms it, times the expanded cotangent.
    const float4* t00 = reinterpret_cast<const float4*>(srcv + o00);
    const float4* t01 = reinterpret_cast<const float4*>(srcv + o01);
    const float4* t10 = reinterpret_cast<const float4*>(srcv + o10);
    const float4* t11 = reinterpret_cast<const float4*>(srcv + o11);
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 a = __ldg(t00 + i);
      const float4 f = __ldg(t01 + i);
      const float4 c = __ldg(t10 + i);
      const float4 h = __ldg(t11 + i);
      dr[4 * i + 0] += e[(4 * i + 0) / CG] * (a.x * w00 + f.x * w01 + c.x * w10 + h.x * w11);
      dr[4 * i + 1] += e[(4 * i + 1) / CG] * (a.y * w00 + f.y * w01 + c.y * w10 + h.y * w11);
      dr[4 * i + 2] += e[(4 * i + 2) / CG] * (a.z * w00 + f.z * w01 + c.z * w10 + h.z * w11);
      dr[4 * i + 3] += e[(4 * i + 3) / CG] * (a.w * w00 + f.w * w01 + c.w * w10 + h.w * w11);
    }

    // dsrc: scatter w_tap * (ref * dcex) into the taps inside the image.
    const float wt[4] = {w00, w01, w10, w11};
    const size_t ot[4] = {o00, o01, o10, o11};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (wt[t] == 0.0f) continue;
      float* dst = dsrcv + ot[t];
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, wt[t] * (r[c] * e[c / CG]));
    }
  }

  float* drp = dref + ((size_t)b * HW + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(drp + c, dr[c]);
}

template <int C>
void launch(const float* ref, const float* src, const float* mat, const float* dv,
            const float* dcorr, float* dref, float* dsrc, int B, int V, int D, int H, int W,
            cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, V, B);
  warp_corr_bwd_kernel<C, 8><<<grid, kThreads, 0, stream>>>(
      ref, src, mat, dv, dcorr, dref, dsrc, V, D, H, W);
}

}  // namespace

extern "C" int warp_corr_bwd_f32(const float* ref, const float* src, const float* mat,
                                 const float* dv, const float* dcorr, float* dref, float* dsrc,
                                 int B, int V, int D, int H, int W, int C, int G,
                                 void* stream) {
  if (D < 1 || G != 8 || B < 1 || B > 65535 || V < 1 || V > 65535 || H < 1 || W < 1) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: launch<8>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s); break;
    case 16: launch<16>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s); break;
    case 32: launch<32>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s); break;
    case 64: launch<64>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
