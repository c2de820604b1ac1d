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
// warp_corr_fwd_plain. The training entropy stays in torch ops on the
// correlation, where autograd sees it. K7 takes any D (the depths run in
// chunks); K1 keeps every chunk's sum over the groups for the entropy, so
// it takes D <= 32.
//
// Bound on the H100: memory. The correlation volume written is V*G*D*H*W
// floats (about 0.9 GB at stage 4 of the DTU eval shape), against ~10*C
// flops per (view, depth, pixel). What held the one-thread-per-pixel design
// back was the gather, not DRAM: lane i's tap lay C*4 bytes from lane
// i-1's, so one warp-wide 16-byte load touched 32 cache lines at C = 64 and
// C = 32 (16 at C = 16, 8 at C = 8). With the same loads at addresses that
// read 512 contiguous bytes, stages 1-2 took a third of the time
// (k1_variants' "coalesced lanes" probe).
//
// Design, from C = 16 on: C/4 lanes share a reference pixel; lane j owns
// channels 4j..4j+3. (At C = 8 a split gains little, 8 lines a load become
// 4, and its staging cost more: one thread per pixel measured faster, so
// warp_corr_pixel_kernel keeps that mapping there.)
//  - Each lane keeps only its float4 of the reference vector. A tap's
//    C-vector is read by the pixel's C/4 lanes at once, so one warp-wide
//    16-byte load reads 32/(C/4) whole C-vectors: 512 bytes, about 4 lines.
//  - Group sums follow the lanes: CG = C/8 channels a group is two lanes at
//    C = 64 (one __shfl_xor_sync), one lane at C = 32, and half a lane at
//    C = 16.
//  - A block takes TP pixels (TP * C/4 = 256 threads) and the depths in
//    chunks of 512/TP. For a chunk, the coordinates and bilinear weights of
//    each (pixel, depth) are computed once, by one thread, into shared
//    memory, and every lane of the pixel reads them from there (a
//    broadcast). The relative projection's top three rows come in from the
//    wrapper, computed there in fp32 without TF32; px, py, z are computed
//    here in fp32 with the plain version's rounding.
//  - The group means of the chunk are staged in shared memory as [g][d][t]
//    (the g stride is 4 banks off a multiple of 32, so the lanes' writes
//    meet no bank conflict) and stored with consecutive threads on
//    consecutive pixels, as float4s where H*W % 4 == 0: the output is
//    [B, V, G, D, H, W], so the stores are coalesced, and the
//    view-weighted sum and Conv3d read it without a transpose.
//  - K1 sums the chunk's groups per (depth, pixel) into a [D][TP] column in
//    shared memory, and after the last chunk computes the entropy with the
//    exact two-pass formula -sum p*log(p + 1e-7), the pixel's lanes
//    splitting the depths.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "warp_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 32;          // K1
constexpr int kChunkPixels = 512;  // (depth, pixel) pairs of a chunk
constexpr int G = 8;
// Channels from which C/4 lanes share a pixel; below, one thread per pixel.
constexpr int kSplitFromC = 16;
constexpr int kPixelThreads = 128;

// Pixels of a block: 256 threads of C/4 lanes each.
__host__ __device__ constexpr int tile_pixels(int C) { return kThreads / (C / 4); }
__host__ __device__ constexpr int chunk_depths(int C) { return kChunkPixels / tile_pixels(C); }
// Floats between two groups of the staged tile: a multiple of 32, plus 4.
constexpr int kGroupStride = kChunkPixels + 4;

size_t smem_bytes(int C, int D, bool entropy) {
  const int tp = tile_pixels(C);
  const int dc = D < chunk_depths(C) ? D : chunk_depths(C);
  // float4 weights + int4 offsets of a chunk, the staged tile, K1's sums.
  const size_t floats =
      (size_t)8 * dc * tp + (size_t)G * kGroupStride + (entropy ? (size_t)D * tp : 0);
  return floats * sizeof(float);
}

template <int C, bool kEntropy>
__global__ void __launch_bounds__(kThreads)
warp_group_corr_kernel(const float* __restrict__ ref,  // [B, H, W, C]
                       const float* __restrict__ src,  // [B, V, H, W, C]
                       const float* __restrict__ mat,  // [B, V, 12]
                       const float* __restrict__ dv,   // [B, D, H, W]
                       float* __restrict__ corr,       // [B, V, G, D, H, W]
                       float* __restrict__ ent,        // [B, V, H, W] (K1)
                       int V, int D, int H, int W) {
  constexpr int L = C / 4;  // lanes per pixel
  constexpr int CG = C / G;
  constexpr int TP = tile_pixels(C);
  constexpr int DC = chunk_depths(C);
  constexpr int GS = kGroupStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dc_max = D < DC ? D : DC;
  float4* s_w = smem4;                                    // [dc][TP]
  int4* s_o = reinterpret_cast<int4*>(smem4 + dc_max * TP);  // [dc][TP]
  float* s_tile = smem + 8 * dc_max * TP;                  // [G][GS]
  float* s_sim = s_tile + G * GS;                          // [D][TP] (K1)

  const int HW = H * W;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const int bv = b * V + v;
  const int p0 = blockIdx.x * TP;
  const int t = threadIdx.x / L;  // this lane's pixel in the tile
  const int j = threadIdx.x % L;  // its float4 of the channels
  const int p = min(p0 + t, HW - 1);  // ragged tail: compute on the last pixel, store nothing

  const float* M = mat + (size_t)bv * 12;
  const float4 r = reinterpret_cast<const float4*>(ref)[((size_t)b * HW + p) * L + j];
  const float4* src4 = reinterpret_cast<const float4*>(src + (size_t)bv * HW * C);
  const float* dvb = dv + (size_t)b * D * HW;

  for (int d0 = 0; d0 < D; d0 += DC) {
    const int nd = min(DC, D - d0);
    for (int i = threadIdx.x; i < nd * TP; i += kThreads) {
      const int tt = i % TP;
      const int pp = min(p0 + tt, HW - 1);
      const Taps tp = taps_at(M, ray(M, pp, W), dvb[(size_t)(d0 + i / TP) * HW + pp], W, H);
      s_w[i] = tp.w;
      s_o[i] = tp.o;
    }
    __syncthreads();
#pragma unroll 2
    for (int dd = 0; dd < nd; ++dd) {
      const Taps tp = {s_w[dd * TP + t], s_o[dd * TP + t]};
      const float4 a = __ldg(src4 + (size_t)tp.o.x * L + j);
      const float4 e = __ldg(src4 + (size_t)tp.o.y * L + j);
      const float4 c = __ldg(src4 + (size_t)tp.o.z * L + j);
      const float4 f = __ldg(src4 + (size_t)tp.o.w * L + j);
      const float o0 = a.x * tp.w.x + e.x * tp.w.y + c.x * tp.w.z + f.x * tp.w.w;
      const float o1 = a.y * tp.w.x + e.y * tp.w.y + c.y * tp.w.z + f.y * tp.w.w;
      const float o2 = a.z * tp.w.x + e.z * tp.w.y + c.z * tp.w.z + f.z * tp.w.w;
      const float o3 = a.w * tp.w.x + e.w * tp.w.y + c.w * tp.w.z + f.w * tp.w.w;
      float* cell = s_tile + dd * TP + t;  // group g at cell[g * GS]
      if constexpr (CG >= 4) {
        float s = r.x * o0 + r.y * o1 + r.z * o2 + r.w * o3;
        if constexpr (CG == 8) s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (CG == 4 || (j & 1) == 0) cell[(j * 4 / CG) * GS] = s / (float)CG;
      } else if constexpr (CG == 2) {
        cell[(2 * j) * GS] = (r.x * o0 + r.y * o1) / 2.0f;
        cell[(2 * j + 1) * GS] = (r.z * o2 + r.w * o3) / 2.0f;
      } else {
        cell[(4 * j) * GS] = r.x * o0;
        cell[(4 * j + 1) * GS] = r.y * o1;
        cell[(4 * j + 2) * GS] = r.z * o2;
        cell[(4 * j + 3) * GS] = r.w * o3;
      }
    }
    __syncthreads();

    // Store the chunk, consecutive threads on consecutive pixels: as float4s
    // where every (g, d) row starts 16-byte aligned, else one float each.
    float* out = corr + (size_t)bv * G * D * HW + (size_t)d0 * HW + p0;
    if ((HW & 3) == 0) {
      constexpr int Q = TP / 4;  // float4s of a tile row
      const int nq = nd * Q;
      for (int i = threadIdx.x; i < G * nq; i += kThreads) {
        const int g = i / nq;
        const int k = 4 * (i - g * nq);  // dd * TP + tt
        const int tt = k % TP;
        if (p0 + tt < HW) {
          *reinterpret_cast<float4*>(out + ((size_t)g * D + k / TP) * HW + tt) =
              *reinterpret_cast<const float4*>(s_tile + g * GS + k);
        }
      }
    } else {
      const int tt = threadIdx.x % TP;
      if (p0 + tt < HW) {
        for (int row = threadIdx.x / TP; row < G * nd; row += kThreads / TP) {
          const int g = row / nd;
          const int dd = row - g * nd;
          out[((size_t)g * D + dd) * HW + tt] = s_tile[g * GS + dd * TP + tt];
        }
      }
    }
    if constexpr (kEntropy) {
      for (int i = threadIdx.x; i < nd * TP; i += kThreads) {
        float sim = 0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) sim += s_tile[g * GS + i];
        s_sim[d0 * TP + i] = sim;
      }
    }
    __syncthreads();
  }
  if constexpr (kEntropy) {
    // Entropy over D of softmax(sim), the plain version's two-pass formula;
    // the pixel's L lanes split the depths and combine by shuffles.
    const float* col = s_sim + t;
    float m = -INFINITY;
    for (int d = j; d < D; d += L) m = fmaxf(m, col[d * TP]);
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float z = 0.0f;
    for (int d = j; d < D; d += L) z += expf(col[d * TP] - m);
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    float h = 0.0f;
    for (int d = j; d < D; d += L) {
      const float pr = expf(col[d * TP] - m) / z;
      h += pr * logf(pr + 1e-7f);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) h += __shfl_xor_sync(0xffffffffu, h, o);
    if (j == 0 && p0 + t < HW) ent[(size_t)bv * HW + p0 + t] = -h;
  }
}

// One thread per pixel (the earlier mapping, kept for C below
// kSplitFromC, where it measured faster): the thread holds the whole
// reference vector and reads each tap's C-vector as C/4 float4s, looping
// over the depths; sum_g corr per depth goes to a shared-memory column.
template <int C, bool kEntropy>
__global__ void __launch_bounds__(kPixelThreads)
warp_corr_pixel_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                       const float* __restrict__ mat, const float* __restrict__ dv,
                       float* __restrict__ corr, float* __restrict__ ent,
                       int V, int D, int H, int W) {
  constexpr int CG = C / G;
  __shared__ float s_sim[kEntropy ? kMaxD * kPixelThreads : 1];
  const int HW = H * W;
  const int p = blockIdx.x * kPixelThreads + threadIdx.x;
  if (p >= HW) return;
  const int bv = blockIdx.z * V + blockIdx.y;
  const float* M = mat + (size_t)bv * 12;
  const float3 rp = ray(M, p, W);
  float r[C];
  const float4* ref4 = reinterpret_cast<const float4*>(ref + ((size_t)blockIdx.z * HW + p) * C);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 q = ref4[i];
    r[4 * i + 0] = q.x;
    r[4 * i + 1] = q.y;
    r[4 * i + 2] = q.z;
    r[4 * i + 3] = q.w;
  }
  const float4* src4 = reinterpret_cast<const float4*>(src + (size_t)bv * HW * C);
  const float* dvp = dv + (size_t)blockIdx.z * D * HW + p;
  float* corrp = corr + (size_t)bv * G * D * HW + p;
  for (int d = 0; d < D; ++d) {
    const Taps tp = taps_at(M, rp, dvp[(size_t)d * HW], W, H);
    const float4* t00 = src4 + (size_t)tp.o.x * (C / 4);
    const float4* t01 = src4 + (size_t)tp.o.y * (C / 4);
    const float4* t10 = src4 + (size_t)tp.o.z * (C / 4);
    const float4* t11 = src4 + (size_t)tp.o.w * (C / 4);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 a = __ldg(t00 + i);
      const float4 e = __ldg(t01 + i);
      const float4 c = __ldg(t10 + i);
      const float4 f = __ldg(t11 + i);
      acc[(4 * i + 0) / CG] += r[4 * i + 0] * (a.x * tp.w.x + e.x * tp.w.y + c.x * tp.w.z + f.x * tp.w.w);
      acc[(4 * i + 1) / CG] += r[4 * i + 1] * (a.y * tp.w.x + e.y * tp.w.y + c.y * tp.w.z + f.y * tp.w.w);
      acc[(4 * i + 2) / CG] += r[4 * i + 2] * (a.z * tp.w.x + e.z * tp.w.y + c.z * tp.w.z + f.z * tp.w.w);
      acc[(4 * i + 3) / CG] += r[4 * i + 3] * (a.w * tp.w.x + e.w * tp.w.y + c.w * tp.w.z + f.w * tp.w.w);
    }
    float sim = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float cg = acc[g] / (float)CG;
      corrp[((size_t)g * D + d) * HW] = cg;
      sim += cg;
    }
    if constexpr (kEntropy) s_sim[d * kPixelThreads + threadIdx.x] = sim;
  }
  if constexpr (!kEntropy) return;
  float m = -INFINITY;
  for (int d = 0; d < D; ++d) m = fmaxf(m, s_sim[d * kPixelThreads + threadIdx.x]);
  float z = 0.0f;
  for (int d = 0; d < D; ++d) z += expf(s_sim[d * kPixelThreads + threadIdx.x] - m);
  float h = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float pr = expf(s_sim[d * kPixelThreads + threadIdx.x] - m) / z;
    h += pr * logf(pr + 1e-7f);
  }
  ent[(size_t)bv * HW + p] = -h;
}

template <int C, bool kEntropy>
cudaError_t launch(const float* ref, const float* src, const float* mat, const float* dv,
                   float* corr, float* ent, int B, int V, int D, int H, int W,
                   cudaStream_t stream) {
  if constexpr (C < kSplitFromC) {
    const dim3 grid((H * W + kPixelThreads - 1) / kPixelThreads, V, B);
    warp_corr_pixel_kernel<C, kEntropy><<<grid, kPixelThreads, 0, stream>>>(
        ref, src, mat, dv, corr, ent, V, D, H, W);
  } else {
    const size_t smem = smem_bytes(C, D, kEntropy);
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(warp_group_corr_kernel<C, kEntropy>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  (int)smem);
      if (rc != cudaSuccess) return rc;
    }
    const dim3 grid((H * W + tile_pixels(C) - 1) / tile_pixels(C), V, B);
    warp_group_corr_kernel<C, kEntropy><<<grid, kThreads, smem, stream>>>(
        ref, src, mat, dv, corr, ent, V, D, H, W);
  }
  return cudaGetLastError();
}

template <bool kEntropy>
int dispatch(const float* ref, const float* src, const float* mat, const float* dv,
             float* corr, float* ent, int B, int V, int D, int H, int W, int C, int groups,
             void* stream) {
  if (D < 1 || (kEntropy && D > kMaxD) || groups != G || B < 1 || B > 65535 || V < 1 ||
      V > 65535 || H < 1 || W < 1) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)launch<8, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s);
    case 16: return (int)launch<16, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s);
    case 32: return (int)launch<32, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s);
    case 64: return (int)launch<64, kEntropy>(ref, src, mat, dv, corr, ent, B, V, D, H, W, s);
    default: return -1;
  }
}

template <int C, bool kEntropy>
int blocks_per_sm(int D) {
  int n = 0;
  cudaError_t rc;
  if constexpr (C < kSplitFromC) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, warp_corr_pixel_kernel<C, kEntropy>, kPixelThreads, 0);
  } else {
    const size_t smem = smem_bytes(C, D, kEntropy);
    rc = smem > 48 * 1024 ? cudaFuncSetAttribute(warp_group_corr_kernel<C, kEntropy>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)
                          : cudaSuccess;
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, warp_group_corr_kernel<C, kEntropy>, kThreads, smem);
    }
  }
  return rc == cudaSuccess ? n : 0;
}

}  // namespace

// K1: corr and entropy.
extern "C" int warp_group_corr_f32(const float* ref, const float* src, const float* mat,
                                   const float* dv, float* corr, float* ent, int B, int V,
                                   int D, int H, int W, int C, int groups, void* stream) {
  return dispatch<true>(ref, src, mat, dv, corr, ent, B, V, D, H, W, C, groups, stream);
}

// K7: corr only.
extern "C" int warp_corr_fwd_f32(const float* ref, const float* src, const float* mat,
                                 const float* dv, float* corr, int B, int V, int D, int H,
                                 int W, int C, int groups, void* stream) {
  return dispatch<false>(ref, src, mat, dv, corr, nullptr, B, V, D, H, W, C, groups, stream);
}

// Resident blocks per SM of K1 (entropy != 0) or K7 at channels C and D
// depths; 0 for a C it does not take.
extern "C" int warp_corr_blocks_per_sm(int C, int D, int entropy) {
  const bool e = entropy != 0;
  switch (C) {
    case 8: return e ? blocks_per_sm<8, true>(D) : blocks_per_sm<8, false>(D);
    case 16: return e ? blocks_per_sm<16, true>(D) : blocks_per_sm<16, false>(D);
    case 32: return e ? blocks_per_sm<32, true>(D) : blocks_per_sm<32, false>(D);
    case 64: return e ? blocks_per_sm<64, true>(D) : blocks_per_sm<64, false>(D);
    default: return 0;
  }
}
