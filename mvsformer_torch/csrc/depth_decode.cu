// K3: the eval depth decode, per pixel of [B, D, H, W] fp32 logits l and
// depths dv:
//   depth = sum_d exp(tmp (l_d - m)) dv_d / sum_d exp(tmp (l_d - m)),
//   conf  = 1 / sum_d exp(l_d - m),   m = max_d l_d.
//
// Replaces: mvsformer_tpu/ops/pallas/stage_tail.py fused_depth_decode.
// Contract: logits and dv [B, D, H, W] fp32 contiguous, any B, D >= 1, H,
// W -> depth and conf [B, H, W] fp32. The plain version is
// ops/stage_tail.py depth_decode_plain (= ops/regression.decode_depth,
// eval "ce").
//
// Bound on the H100: memory. Per pixel it reads 2 D floats and writes 2;
// its ~25 operations a depth (two expf, the sums) are far below the 67
// TFLOP/s fp32 rate. The DTU request's 4 launches move 7.3 / 14.6 / 28.3 /
// 56.6 MB of inputs: 0.037 ms at 3.35 TB/s in all. The first two stages
// move too little to fill the card for long, so there the launch sets the
// time; this kernel is launched through ctypes like the port's others.
//
// Design: one thread takes VEC consecutive pixels of the flat H*W axis of
// one batch entry (VEC = 4, 16-byte loads, where H*W % 4 == 0 and every
// pointer is 16-byte aligned and the depths fit one pass, DEPTHS <=
// kVecDepths; else VEC = 1), so a warp's loads of one depth plane are
// contiguous. It reads the logits once: a pass holds DEPTHS of them and
// of the depths a pixel in registers (DEPTHS the smallest power of two from
// 4 that covers a lane's depths, with VEC * DEPTHS <= kRegs), all loaded
// before the first is used, then takes their max and the three sums from
// registers; more depths take several passes, whose partials are merged.
// A pixel's depths may also be split over kLanes lanes (lane r takes d =
// r, r + kLanes, ...) whose partials meet by shuffles.
//
// A partial of a set of depths is (m, s1, st, ws): its max logit,
// sum exp(l - m), sum exp(tmp (l - m)) and sum exp(tmp (l - m)) dv. Two
// merge as the one with the larger max keeps its sums and the other's are
// scaled by exp(m' - m) and exp(tmp (m' - m)); an empty partial (m = -inf)
// merges as the identity. tests/test_torch_kernels.py emulates this merge
// on the CPU against the Pallas kernel and the JAX decode.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kRegs = 32;       // most depths x pixels a lane holds in registers
constexpr int kVecDepths = 8;   // most depths a lane takes with VEC = 4 (one pass)
constexpr int kLanes = 1;       // lanes a pixel's depths are split over (a power of two)
static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "a pixel's lanes are a power of two within a warp");

struct Partial {
  float m, s1, st, ws;
};

__device__ __forceinline__ Partial merge(const Partial& a, const Partial& b, float tmp) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  const float m = fmaxf(a.m, b.m);
  const bool a_top = a.m == m, b_top = b.m == m;
  const float ca = a_top ? 1.f : expf(a.m - m), cb = b_top ? 1.f : expf(b.m - m);
  const float ta = a_top ? 1.f : expf(tmp * (a.m - m));
  const float tb = b_top ? 1.f : expf(tmp * (b.m - m));
  return {m, a.s1 * ca + b.s1 * cb, a.st * ta + b.st * tb, a.ws * ta + b.ws * tb};
}

template <int VEC>
__device__ __forceinline__ void load(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// groups = B * HW / VEC; thread t is lane t % kLanes of group t / kLanes.
template <int DEPTHS, int VEC>
__global__ void __launch_bounds__(kThreads) depth_decode_kernel(
    const float* __restrict__ logits, const float* __restrict__ dv, float* __restrict__ depth,
    float* __restrict__ conf, int D, int HW, int groups, float tmp) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = t % kLanes;
  const bool valid = t / kLanes < groups;
  const int g = valid ? t / kLanes : 0;  // past the end: compute group 0, store nothing
  const int per_batch = HW / VEC;
  const int b = g / per_batch;
  const int p = (g - b * per_batch) * VEC;
  const float* lp = logits + (size_t)b * D * HW + p;
  const float* dp = dv + (size_t)b * D * HW + p;

  Partial acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = {-INFINITY, 0.f, 0.f, 0.f};
  for (int d0 = lane; d0 < D; d0 += DEPTHS * kLanes) {
    const int n = min(DEPTHS, (D - d0 + kLanes - 1) / kLanes);  // depths of this pass
    // Every load of the pass is issued before the first is used: the loads
    // are unconditional (a slot past the pass's depths reads the last
    // plane again, a cache hit, and is not used), so none waits behind a
    // branch on n.
    float l[DEPTHS][VEC], w[DEPTHS][VEC];
#pragma unroll
    for (int j = 0; j < DEPTHS; ++j) {
      const size_t plane = (size_t)min(d0 + j * kLanes, D - 1) * HW;
      load<VEC>(l[j], lp + plane);
      load<VEC>(w[j], dp + plane);
    }
    Partial part[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float m = l[0][v];
#pragma unroll
      for (int j = 1; j < DEPTHS; ++j)
        if (j < n) m = fmaxf(m, l[j][v]);
      part[v] = {m, 0.f, 0.f, 0.f};
    }
#pragma unroll
    for (int j = 0; j < DEPTHS; ++j) {
      if (j < n) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float x = l[j][v] - part[v].m;
          const float et = expf(tmp * x);
          part[v].s1 += expf(x);
          part[v].st += et;
          part[v].ws = fmaf(et, w[j][v], part[v].ws);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = merge(acc[v], part[v], tmp);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const Partial o = {__shfl_xor_sync(0xffffffffu, acc[v].m, off),
                         __shfl_xor_sync(0xffffffffu, acc[v].s1, off),
                         __shfl_xor_sync(0xffffffffu, acc[v].st, off),
                         __shfl_xor_sync(0xffffffffu, acc[v].ws, off)};
      acc[v] = merge(acc[v], o, tmp);
    }
  }
  if (valid && lane == 0) {
    float out_d[VEC], out_c[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      out_d[v] = acc[v].ws / acc[v].st;
      out_c[v] = 1.f / acc[v].s1;
    }
    store<VEC>(depth + (size_t)b * HW + p, out_d);
    store<VEC>(conf + (size_t)b * HW + p, out_c);
  }
}

template <int DEPTHS, int VEC>
int launch(const float* logits, const float* dv, float* depth, float* conf, int B, int D, int HW,
           float tmp, cudaStream_t stream) {
  const int groups = B * (HW / VEC);
  const long long threads = (long long)groups * kLanes;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  depth_decode_kernel<DEPTHS, VEC><<<blocks, kThreads, 0, stream>>>(logits, dv, depth, conf, D,
                                                                      HW, groups, tmp);
  return static_cast<int>(cudaGetLastError());
}

// The smallest DEPTHS from 4 (a power of two) that holds a lane's depths,
// at most kRegs / VEC.
template <int VEC, int DEPTHS = 4>
int launch_fitting(int per_lane, const float* logits, const float* dv, float* depth,
                   float* conf, int B, int D, int HW, float tmp, cudaStream_t stream) {
  if constexpr (DEPTHS * VEC < kRegs) {
    if (per_lane > DEPTHS)
      return launch_fitting<VEC, DEPTHS * 2>(per_lane, logits, dv, depth, conf, B, D, HW, tmp,
                                             stream);
  }
  return launch<DEPTHS, VEC>(logits, dv, depth, conf, B, D, HW, tmp, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int depth_decode_f32(const float* logits, const float* dv, float* depth, float* conf,
                                int B, int D, int HW, float tmp, void* stream) {
  if (B < 1 || D < 1 || HW < 1 || (long long)B * HW * kLanes > INT_MAX) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_lane = (D + kLanes - 1) / kLanes;
  const bool vec = HW % 4 == 0 && per_lane <= kVecDepths && aligned16(logits) &&
                   aligned16(dv) && aligned16(depth) && aligned16(conf);
  if (vec) return launch_fitting<4>(per_lane, logits, dv, depth, conf, B, D, HW, tmp, s);
  return launch_fitting<1>(per_lane, logits, dv, depth, conf, B, D, HW, tmp, s);
}
