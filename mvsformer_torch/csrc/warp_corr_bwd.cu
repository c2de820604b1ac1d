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
// The taps come from warp_taps.cuh, K7's own code, so they are the
// forward's to the last bit. The plain version is ops/warp_corr_train.py
// warp_corr_bwd_plain: autograd through the plain forward. The Pallas
// kernel forms dsrc as the adjoint of its banded matmuls, adding into a
// band of dsrc in HBM from one grid step to the next, which is race-free
// only because TPU grid steps run in order; here blocks run in parallel,
// and dsrc is a reduction across them.
//
// Bound on the H100: memory (chip_smoke.k8_cost: ref, src, dcorr and the
// depths read once, dref and dsrc written once; dcorr is as large as the
// forward's output), plus the reductions into dsrc that the design leaves.
// One thread per pixel with one scalar fp32 atomicAdd per (view, depth,
// pixel, tap, channel) -- 671 M per launch at every stage of the DTU
// training micro-batch -- took 4.5-5.2 ms a launch whatever the stage, 85%
// of it the scatter. On that mapping (k8_variants' probes) the scatter as
// plain stores was slower at C = 64 and 32: the address pattern, each
// lane's 4 bytes C*4 bytes from its neighbour's, cost as much as the
// atomics; as one float4 atomic per 4 channels it took 1.3-1.6 ms.
//
// Design, from C = 16 on K7's channel split (two lanes a pixel at C = 8):
//  - C/4 lanes share a reference pixel, lane j owning one float4 of its
//    channels, and a block takes a run of TP pixels (TP * lanes = 256
//    threads) and the depths in chunks of 512 (depth, pixel) pairs. For a
//    chunk the taps and the group cotangents dcorr / CG of each pair are
//    computed once, by one thread, into shared memory.
//  - dref: a lane sums its float4 of dcex * warped (the warped vector as K7
//    forms it, the pixel's lanes reading each tap's C-vector together) over
//    the depths in registers, and adds it to dref with one 16-byte vector
//    reduction (red.global.add.v4.f32, REDG.E.ADD.F32x4) at the end: the V
//    views of a pixel share it.
//  - dsrc: while a pixel's four taps stay on one square of source pixels
//    from depth to depth, its lanes sum w_tap * dcex per tap and group in
//    registers (ref is the same at every depth, so it multiplies once);
//    when the square moves, and at the chunk's end, each lane adds ref
//    times those sums to the square's four source pixels with one vector
//    reduction each. The pixel's lanes reduce a tap's whole C-vector at
//    once: consecutive lanes, consecutive 16 bytes. dsrc is zeroed by the
//    wrapper.
//  Measured against (k8_variants): one reduction per depth, 2.9 / 2.5 /
//  1.4 times slower at stages 1-3 and level at stage 4; a shared-memory
//  dsrc window per block over the source box its taps touch, flushed with
//  vector reductions, 1.1-1.4 times slower at stages 1-3 and 6% faster at
//  stage 4: this card has no fp32 add in shared memory (each is a load and
//  a compare-and-swap loop), and the register sums leave it few
//  reductions to merge.
//  The reductions make the order of every sum, and so its last bits, vary
//  from run to run: compare dref and dsrc with a tolerance relative to their
//  scale, never bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "warp_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int G = 8;
constexpr int kChunkPixels = 512;  // (depth, pixel) pairs of a chunk

// Lanes that share a reference pixel; each holds C / 4 / lanes float4s of it.
__host__ __device__ constexpr int lanes_per_pixel(int C) { return C / 4; }
__host__ __device__ constexpr int tile_pixels(int C) { return kThreads / lanes_per_pixel(C); }
__host__ __device__ constexpr int chunk_depths(int C) { return kChunkPixels / tile_pixels(C); }

// Floats between two groups of the staged cotangents: 4 banks off a
// multiple of 32, so the lanes of a warp, reading several groups of
// several pixels at once, meet no bank conflict.
__host__ __device__ constexpr int group_stride(int pairs) { return ((pairs + 31) & ~31) + 4; }

size_t smem_bytes(int C, int D) {
  const int pairs = (D < chunk_depths(C) ? D : chunk_depths(C)) * tile_pixels(C);
  // float4 weights + int4 tap coordinates of a chunk, and its cotangents.
  return sizeof(float) * ((size_t)8 * pairs + (size_t)G * group_stride(pairs));
}

// One 16-byte reduction into global memory (REDG.E.ADD.F32x4 on sm_90).
__device__ __forceinline__ void red_global4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// r times NE group values spread over the float4's four channels: one value
// for all four at C/G >= 4, two at C/G = 2, four at C/G = 1.
template <int NE>
__device__ __forceinline__ float4 times_groups(float4 r, const float* s) {
  return make_float4(r.x * s[0], r.y * s[NE / 4], r.z * s[2 * NE / 4], r.w * s[3 * NE / 4]);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
warp_corr_bwd_kernel(const float* __restrict__ ref,    // [B, H, W, C]
                     const float* __restrict__ src,    // [B, V, H, W, C]
                     const float* __restrict__ mat,    // [B, V, 12]
                     const float* __restrict__ dv,     // [B, D, H, W]
                     const float* __restrict__ dcorr,  // [B, V, G, D, H, W]
                     float* __restrict__ dref,         // [B, H, W, C], zeroed
                     float* __restrict__ dsrc,         // [B, V, H, W, C], zeroed
                     int V, int D, int H, int W) {
  constexpr int L = lanes_per_pixel(C);
  constexpr int C4 = C / 4;    // float4s of a channel vector
  constexpr int NV = C4 / L;   // float4s of a lane
  constexpr int CG = C / G;
  constexpr int NE = CG >= 4 ? 1 : 4 / CG;  // groups of a float4
  constexpr int TP = tile_pixels(C);
  constexpr int DC = chunk_depths(C);
  const int pairs = min(D, DC) * TP;
  const int GS = group_stride(pairs);
  extern __shared__ float4 smem4[];
  float4* s_w = smem4;                                      // [pairs]
  int4* s_xy = reinterpret_cast<int4*>(smem4 + pairs);      // [pairs]
  float* s_e = reinterpret_cast<float*>(smem4 + 2 * pairs);  // [G][GS]

  const int HW = H * W;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const int bv = b * V + v;
  const int p0 = blockIdx.x * TP;
  const int t = threadIdx.x / L;  // this lane's pixel in the tile
  const int j = threadIdx.x % L;
  const int p = min(p0 + t, HW - 1);  // ragged tail: no taps, no dref

  const float* M = mat + (size_t)bv * 12;
  const float4* src4 = reinterpret_cast<const float4*>(src + (size_t)bv * HW * C);
  float* dsrcv = dsrc + (size_t)bv * HW * C;
  const float* dvb = dv + (size_t)b * D * HW;
  const float* dcb = dcorr + (size_t)bv * G * D * HW;
  float4 r[NV], dr[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    r[n] = reinterpret_cast<const float4*>(ref)[((size_t)b * HW + p) * C4 + j * NV + n];
    dr[n] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int nd = min(DC, D - d0);
    // Taps and cotangents of each (depth, pixel) of the chunk; none past the
    // image's last pixel.
    for (int i = threadIdx.x; i < nd * TP; i += kThreads) {
      const int pp = p0 + i % TP;
      TapSquare s = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_int4(0, 0, 0, 0)};
      if (pp < HW) {
        const size_t dq = (size_t)(d0 + i / TP) * HW + pp;
        s = tap_square(M, ray(M, pp, W), dvb[dq], W, H);
#pragma unroll
        for (int g = 0; g < G; ++g) s_e[g * GS + i] = dcb[(size_t)g * D * HW + dq] / (float)CG;
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) s_e[g * GS + i] = 0.0f;
      }
      s_w[i] = s.w;
      s_xy[i] = s.xy;
    }
    __syncthreads();

    int4 sq = make_int4(-1, -1, -1, -1);  // the square being summed
    float acc[NV][NE][4];                 // per float4, group, tap: sum of w_tap * dcex
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int g = 0; g < NE; ++g) acc[n][g][0] = acc[n][g][1] = acc[n][g][2] = acc[n][g][3] = 0.0f;
    }
    // Add ref times the sums to the square's taps, and start again from 0.
    auto flush = [&]() {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t o = (size_t)((q & 2) ? sq.w : sq.z) * W + ((q & 1) ? sq.y : sq.x);
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float s[NE];
          bool any = false;
#pragma unroll
          for (int g = 0; g < NE; ++g) {
            s[g] = acc[n][g][q];
            any = any || s[g] != 0.0f;
            acc[n][g][q] = 0.0f;
          }
          if (any) red_global4(dsrcv + o * C + (j * NV + n) * 4, times_groups<NE>(r[n], s));
        }
      }
    };
#pragma unroll 2
    for (int dd = 0; dd < nd; ++dd) {
      const int k = dd * TP + t;
      const float4 w = s_w[k];
      const int4 xy = s_xy[k];
      if (xy.x != sq.x || xy.y != sq.y || xy.z != sq.z || xy.w != sq.w) {
        flush();
        sq = xy;
      }
      const int o00 = xy.z * W + xy.x, o01 = xy.z * W + xy.y;
      const int o10 = xy.w * W + xy.x, o11 = xy.w * W + xy.y;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int jj = j * NV + n;  // this float4 of the channels
        float ev[NE];
#pragma unroll
        for (int g = 0; g < NE; ++g) ev[g] = s_e[((4 * jj) / CG + g) * GS + k];
        const float4 e = times_groups<NE>(make_float4(1.0f, 1.0f, 1.0f, 1.0f), ev);
        const float4 a = __ldg(src4 + (size_t)o00 * C4 + jj);
        const float4 f = __ldg(src4 + (size_t)o01 * C4 + jj);
        const float4 c = __ldg(src4 + (size_t)o10 * C4 + jj);
        const float4 h = __ldg(src4 + (size_t)o11 * C4 + jj);
        dr[n].x += e.x * (a.x * w.x + f.x * w.y + c.x * w.z + h.x * w.w);
        dr[n].y += e.y * (a.y * w.x + f.y * w.y + c.y * w.z + h.y * w.w);
        dr[n].z += e.z * (a.z * w.x + f.z * w.y + c.z * w.z + h.z * w.w);
        dr[n].w += e.w * (a.w * w.x + f.w * w.y + c.w * w.z + h.w * w.w);
#pragma unroll
        for (int g = 0; g < NE; ++g) {
          acc[n][g][0] += w.x * ev[g];
          acc[n][g][1] += w.y * ev[g];
          acc[n][g][2] += w.z * ev[g];
          acc[n][g][3] += w.w * ev[g];
        }
      }
    }
    flush();
    __syncthreads();
  }

  if (p0 + t < HW) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      red_global4(dref + ((size_t)b * HW + p) * C + (j * NV + n) * 4, dr[n]);
    }
  }
}

template <int C>
cudaError_t launch(const float* ref, const float* src, const float* mat, const float* dv,
                   const float* dcorr, float* dref, float* dsrc, int B, int V, int D, int H,
                   int W, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, D);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        warp_corr_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid((H * W + tile_pixels(C) - 1) / tile_pixels(C), V, B);
  warp_corr_bwd_kernel<C><<<grid, kThreads, smem, stream>>>(ref, src, mat, dv, dcorr, dref,
                                                            dsrc, V, D, H, W);
  return cudaGetLastError();
}

template <int C>
int blocks_per_sm(int D) {
  const size_t smem = smem_bytes(C, D);
  cudaError_t rc = smem > 48 * 1024
                       ? cudaFuncSetAttribute(warp_corr_bwd_kernel<C>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem)
                       : cudaSuccess;
  int n = 0;
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, warp_corr_bwd_kernel<C>, kThreads,
                                                       smem);
  }
  return rc == cudaSuccess ? n : 0;
}

}  // namespace

extern "C" int warp_corr_bwd_f32(const float* ref, const float* src, const float* mat,
                                 const float* dv, const float* dcorr, float* dref, float* dsrc,
                                 int B, int V, int D, int H, int W, int C, int groups,
                                 void* stream) {
  if (D < 1 || groups != G || B < 1 || B > 65535 || V < 1 || V > 65535 || H < 1 || W < 1) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)launch<8>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s);
    case 16: return (int)launch<16>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s);
    case 32: return (int)launch<32>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s);
    case 64: return (int)launch<64>(ref, src, mat, dv, dcorr, dref, dsrc, B, V, D, H, W, s);
    default: return -1;
  }
}

// Resident blocks per SM at C channels and D depths; 0 for a C the kernel
// does not take.
extern "C" int warp_corr_bwd_blocks_per_sm(int C, int D) {
  switch (C) {
    case 8: return blocks_per_sm<8>(D);
    case 16: return blocks_per_sm<16>(D);
    case 32: return blocks_per_sm<32>(D);
    case 64: return blocks_per_sm<64>(D);
    default: return 0;
  }
}
