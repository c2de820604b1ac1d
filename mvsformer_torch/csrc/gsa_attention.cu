// K6: Twins global sub-sampled attention, per head softmax(q k^T * s) v,
// both products in 3xTF32 on the tensor cores.
//
// Replaces: mvsformer_tpu/ops/pallas/gsa_attention.py gsa_attention.
// Contract: q [B,N,C], k and v [B,Nk,C] (any row strides, unit stride
// along C), heads as contiguous 32-wide slices of C -> out [B,N,C]
// (contiguous). Logits, softmax and probabilities are fp32 (the Pallas
// kernel casts the probabilities to bf16; the contract does not). The plain
// version is ops/gsa_attention.py gsa_attention_plain.
//
// Bound on the H100: operations on the tensor cores. The two products are
// 2 * N * Nk * C multiply-adds per image, run in 3xTF32 (three TF32
// products each, which keeps fp32's accuracy) over 494.7 TFLOP/s dense:
// 0.278 ms for the DTU request's 9 launches. Its bytes (q, k and v read
// once, out written once) need 0.076 ms, the softmax's ~5 fp32 operations a
// logit 0.027 ms. The [B, heads, N, Nk] logits and probabilities never
// reach device memory.
//
// Design: one warp per 16 query rows of one head, 4 warps a block of one
// (head, image); every product on mma.sync.m16n8k8 TF32 (tf32_mma.cuh).
//  - Each lane splits its Q fragment once, to nearest (split_a), and keeps
//    hi and lo for every key: 32 registers.
//  - K and V pass through shared memory in tiles of KT keys, double
//    buffered with cp.async (16 bytes a copy, zero-filled past Nk), so any
//    Nk >= 1 works and the next tile's copy overlaps this tile's products.
//    Rows lie 40 (K) and 36 (V) floats apart, so the B-fragment reads meet
//    no bank conflict: K as one float2 (key g, dims 2t and 2t + 1), V as two
//    floats (keys 2t and 2t + 1, dim g).
//  - S = Q K^T: K = 8 head dims a chunk, 4 chunks, each summed from zero
//    and added to S in round-to-nearest. Lane 4g + t holds S(g, 2t),
//    S(g, 2t + 1), S(g + 8, 2t), S(g + 8, 2t + 1) of an 8-key n-tile.
//  - O += P V reduces over keys, ordered by the header's convention: A
//    columns t and t + 4 of a chunk of 8 keys are keys 2t and 2t + 1. P's A
//    fragment is then the lane's own four S accumulators after the
//    softmax, taken as d0, d2, d1, d3: no shuffle and no trip through
//    shared memory between the two products. V's B fragment is V(2t, g),
//    V(2t + 1, g). Each 8-key chunk is summed from zero and added to O.
//  - Online softmax per tile on the fragments: a lane owns rows g and
//    g + 8, a row's max takes two quad shuffles (xor 1, 2), O and the
//    lane's partial row sums are rescaled once a tile, and the four partial
//    sums of a row meet at the end. Keys past Nk are -inf logits; rows past
//    N are computed from row N - 1 and not stored.
//  - K, V and P are split where read, by truncation: hi = x truncated to
//    TF32, lo = x - hi (exact) truncated, so hi + lo is x within 2^-20 |x|;
//    two logic ops and a subtraction a value.
//
// Accuracy of the softmax: exp(s x - s max) = exp2(c x - m), c = s log2(e)
// rounded to fp32 (on the host), m = c max(x) rounded. Each probability is
// 2^fmaf(x, c, -m): its argument rounded once (2^-24 relative), the power
// by ex2.approx within 2 ulp (what exp2f computes, less its path for results
// below 2^-126, which weigh nothing beside the row's largest, 1), as close
// as expf of the plain version's fp32 logit. c's rounding scales every
// logit alike by at most 2^-24, a change of the temperature that moves the
// output by 2^-24 times the covariance of logit and v under p: a few 1e-7
// of the output's scale at most, since the logits that carry weight lie
// within about ln(Nk) of the largest. tests/test_torch_gsa_tf32.py emulates
// this arithmetic on the CPU against float64.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int HD = 32;                   // head width
constexpr int kWarps = 4;                // warps a block
constexpr int kMinBlocks = 4;            // resident blocks an SM, for the register cap
constexpr int MT = 1;                    // 16-row M tiles a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * MT * kWarps;  // query rows a block
constexpr int KT = 64;                   // keys a shared-memory tile
constexpr int NT = KT / 8;               // 8-key n-tiles a tile
constexpr int KS = 40, VS = 36;          // row strides (floats) of the K and V tiles
static_assert((8 * KT) % kThreads == 0, "a tile's 16-byte copies spread evenly");
static_assert(KS % 32 == 8 && VS % 16 == 4 && KS % 4 == 0 && VS % 4 == 0,
              "conflict-free B-fragment reads, 16-byte aligned rows");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Keys k0 .. k0 + KT - 1 of one head's K and V into ks and vs, zero past Nk.
__device__ __forceinline__ void copy_tile(float* ks, float* vs, const float* kb,
                                          const float* vb, long long k_sn, long long v_sn,
                                          int k0, int Nk) {
#pragma unroll
  for (int u = 0; u < 8 * KT / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int key = i >> 3, d = (i & 7) * 4;
    const bool valid = k0 + key < Nk;
    const long long row = valid ? k0 + key : 0;
    cp_async16(ks + key * KS + d, kb + row * k_sn + d, valid);
    cp_async16(vs + key * VS + d, vb + row * v_sn + d, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// 2^x by the SFU, results below 2^-126 flushed to zero: exp2f is the same
// instruction behind a test and a rescale for those, and measured 2% slower
// (python -m mvsformer_torch.k6_variants).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_trunc(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// A B fragment (b0, b1) as mma_3xtf32 takes it: (hi b0, hi b1, lo b0, lo b1).
__device__ __forceinline__ float4 split_b(float b0, float b1) {
  const uint32_t h0 = tf32_trunc(b0), h1 = tf32_trunc(b1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(tf32_trunc(__fsub_rn(b0, __uint_as_float(h0)))),
                     __uint_as_float(tf32_trunc(__fsub_rn(b1, __uint_as_float(h1)))));
}

// P's A fragment from the lane's S accumulators d of one 8-key n-tile:
// (row g, key 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) = d0, d2, d1, d3.
__device__ __forceinline__ void split_p(const float* d, uint32_t* ah, uint32_t* al) {
  const float a[4] = {d[0], d[2], d[1], d[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_trunc(a[i]);
    al[i] = tf32_trunc(__fsub_rn(a[i], __uint_as_float(ah[i])));
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gsa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int N, int Nk, int C,
           long long q_sb, long long q_sn, long long k_sb, long long k_sn, long long v_sb,
           long long v_sn, float c) {
  __shared__ __align__(16) float ks[2][KT * KS];
  __shared__ __align__(16) float vs[2][KT * VS];

  const int b = blockIdx.z, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16 * MT;  // the warp's first row
  const bool busy = r0 < N;  // a warp past N still copies and meets the barriers

  const float* kb = k + b * k_sb + head * HD;
  const float* vb = v + b * v_sb + head * HD;
  copy_tile(ks[0], vs[0], kb, vb, k_sn, v_sn, 0, Nk);

  uint32_t qh[MT][4][4], ql[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* qb = q + b * q_sb + head * HD + 2 * t;
    const float* q0 = qb + min(r0 + 16 * m + g, N - 1) * q_sn;
    const float* q1 = qb + min(r0 + 16 * m + g + 8, N - 1) * q_sn;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      split_a(__ldg(reinterpret_cast<const float2*>(q0 + 8 * ch)),
              __ldg(reinterpret_cast<const float2*>(q1 + 8 * ch)), qh[m][ch], ql[m][ch]);
  }
  float o[MT][4][4], mx[MT][2], l[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][f][e] = 0.0f;
    mx[m][0] = mx[m][1] = -INFINITY;
    l[m][0] = l[m][1] = 0.0f;
  }

  const int ntiles = (Nk + KT - 1) / KT;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      copy_tile(ks[(it + 1) & 1], vs[(it + 1) & 1], kb, vb, k_sn, v_sn, (it + 1) * KT, Nk);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile it has landed for every thread's copies
    if (busy) {
      const float* kt = ks[it & 1];
      const float* vt = vs[it & 1];
      const int k0 = it * KT;

      // S = Q K^T over the tile's keys, one 8-key n-tile at a time.
      float s[MT][NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = kt + (8 * j + g) * KS + 2 * t;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float2 x = *reinterpret_cast<const float2*>(kr + 8 * ch);
          const float4 bk = split_b(x.x, x.y);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_3xtf32(part, qh[m][ch], ql[m][ch], bk);
#pragma unroll
            for (int e = 0; e < 4; ++e) s[m][j][e] = ch == 0 ? part[e] : s[m][j][e] + part[e];
          }
        }
      }
      if (k0 + KT > Nk) {  // the last tile: keys past Nk take no weight
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * t + (e & 1) >= Nk) s[m][j][e] = -INFINITY;
      }

      // Online softmax: rows g (elements 0, 1) and g + 8 (elements 2, 3).
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) x = fmaxf(x, fmaxf(s[m][j][2 * h], s[m][j][2 * h + 1]));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float mnew = fmaxf(mx[m][h], x * c);
          const float corr = exp2f(mx[m][h] - mnew);  // 0 on the first tile (mx = -inf)
          mx[m][h] = mnew;
          l[m][h] *= corr;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            o[m][f][2 * h] *= corr;
            o[m][f][2 * h + 1] *= corr;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              s[m][j][e] = exp2_ftz(fmaf(s[m][j][e], c, -mnew));
              l[m][h] += s[m][j][e];
            }
        }
      }

      // O += P V, one 8-key chunk at a time.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) split_p(s[m][j], ph[m], pl[m]);
        const float* vr = vt + (8 * j + 2 * t) * VS + g;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float4 bv = split_b(vr[8 * f], vr[VS + 8 * f]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_3xtf32(part, ph[m], pl[m], bv);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[m][f][e] += part[e];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with tile it before it is overwritten
  }
  if (!busy) return;

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[m][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.0f / sum;
      const int row = r0 + 16 * m + g + 8 * h;
      if (row >= N) continue;
      float* op = out + ((long long)b * N + row) * C + head * HD + 2 * t;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        *reinterpret_cast<float2*>(op + 8 * f) =
            make_float2(o[m][f][2 * h] * inv, o[m][f][2 * h + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int gsa_attention_f32(const float* q, const float* k, const float* v, float* out,
                                 int B, int N, int Nk, int num_heads, long long q_sb,
                                 long long q_sn, long long k_sb, long long k_sn,
                                 long long v_sb, long long v_sn, float scale, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || Nk < 1 || num_heads < 1 || num_heads > 65535)
    return -1;
  const float c = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const dim3 grid((N + kRows - 1) / kRows, num_heads, B);
  gsa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, Nk, num_heads * HD, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, c);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel (negative: a CUDA error), for the
// occupancy the design note promises.
extern "C" int gsa_attention_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gsa_kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
