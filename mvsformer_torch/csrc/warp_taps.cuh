// The plane-sweep warp's bilinear taps: what K1/K7 (warp_corr.cu) and K8
// (warp_corr_bwd.cu) share, so the backward's taps are the forward's to the
// last bit by construction.
//
// For a reference pixel p at depth d, the relative projection M (rows 0-2 of
// src @ inv(ref), [3, 4], computed by the wrapper) gives the source
// coordinates (px, py) = (X / (Z + 1e-6), Y / (Z + 1e-6)), with
// [X, Y, Z] = M[:, :3] (x, y, 1) * d + M[:, 3]. The four taps are the
// align-corners bilinear neighbours, zero-padded outside the image, as
// geometry.bilinear_sample and the plain versions in ops/warp_corr.py have
// them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The taps of one (pixel, depth): weights and source pixel coordinates.
struct TapSquare {
  float4 w;  // bilinear weights of (x0, y0), (x1, y0), (x0, y1), (x1, y1); 0 if invalid
  int4 xy;   // (ix0, ix1, iy0, iy1), clamped into the image; exact where a weight is non-zero
};

// The same taps as source pixel indices iy * W + ix.
struct Taps {
  float4 w;
  int4 o;
};

// Coordinates use explicitly rounded multiplies and adds (no FMA
// contraction) in the plain version's order, so px, py match it bit for
// bit: the correlation is steep in px where features change fast.
__device__ __forceinline__ float3 ray(const float* M, int p, int W) {
  const int yi = p / W;
  const float fx = (float)(p - yi * W);
  const float fy = (float)yi;
  return make_float3(__fadd_rn(__fadd_rn(__fmul_rn(M[0], fx), __fmul_rn(M[1], fy)), M[2]),
                     __fadd_rn(__fadd_rn(__fmul_rn(M[4], fx), __fmul_rn(M[5], fy)), M[6]),
                     __fadd_rn(__fadd_rn(__fmul_rn(M[8], fx), __fmul_rn(M[9], fy)), M[10]));
}

__device__ __forceinline__ TapSquare tap_square(const float* M, float3 r, float depth, int W,
                                                int H) {
  const float X = __fadd_rn(__fmul_rn(r.x, depth), M[3]);
  const float Y = __fadd_rn(__fmul_rn(r.y, depth), M[7]);
  const float Z = __fadd_rn(__fmul_rn(r.z, depth), M[11]);
  const float sx = __fdiv_rn(X, __fadd_rn(Z, 1e-6f));
  const float sy = __fdiv_rn(Y, __fadd_rn(Z, 1e-6f));
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);
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
  TapSquare s;
  s.w = make_float4((1.0f - wx) * (1.0f - wy) * (vx0 * vy0), wx * (1.0f - wy) * (vx1 * vy0),
                    (1.0f - wx) * wy * (vx0 * vy1), wx * wy * (vx1 * vy1));
  // Invalid taps point at a clamped in-image pixel with weight 0.
  s.xy = make_int4((int)fminf(fmaxf(x0, 0.0f), wmax), (int)fminf(fmaxf(x1, 0.0f), wmax),
                   (int)fminf(fmaxf(y0, 0.0f), hmax), (int)fminf(fmaxf(y1, 0.0f), hmax));
  return s;
}

__device__ __forceinline__ Taps taps_at(const float* M, float3 r, float depth, int W, int H) {
  const TapSquare s = tap_square(M, r, depth, W, H);
  Taps t;
  t.w = s.w;
  t.o = make_int4(s.xy.z * W + s.xy.x, s.xy.z * W + s.xy.y, s.xy.w * W + s.xy.x,
                  s.xy.w * W + s.xy.y);
  return t;
}
