// K6: Twins global sub-sampled attention, per head softmax(q k^T * s) v.
//
// Replaces: mvsformer_tpu/ops/pallas/gsa_attention.py gsa_attention.
// Contract: q [B,N,C], k and v [B,Nk,C] (any row strides, unit stride
// along C), heads as contiguous 32-wide slices of C -> out [B,N,C]
// (contiguous). Logits, softmax and probabilities are fp32 (the Pallas
// kernel casts the probabilities to bf16; the contract does not). The plain
// version is ops/gsa_attention.py gsa_attention_plain.
//
// Bound on the H100: operations. 4 * N * Nk * C flop per image (the two
// products) in fp32 CUDA cores against 4 * (2 N C + 2 Nk C) bytes: the
// [B, heads, N, Nk] logits and probabilities, which the plain version
// writes and reads back, never reach device memory.
//
// Design: one thread per query row, one block per (128 rows, head, image).
//  - The thread keeps its 32-wide q row and its 32 output sums in registers.
//  - K and V stream through shared memory in chunks of 64 keys, so any Nk
//    works; every thread of the block reads the same key at the same time,
//    so each read is a float4 broadcast, reused for 4 FMAs per thread.
//  - Online softmax: scores of 32 keys at a time sit in registers; the
//    running max and sum are rescaled once per 32 keys, not per key.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int HD = 32;        // head width
constexpr int kThreads = 128; // query rows per block
constexpr int KC = 64;        // keys per shared-memory chunk
constexpr int SUB = 32;       // keys per register batch of scores

__global__ void __launch_bounds__(kThreads)
gsa_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int N, int Nk,
           int C, long long q_sb, long long q_sn, long long k_sb, long long k_sn,
           long long v_sb, long long v_sn, float scale) {
  __shared__ __align__(16) float ks[KC][HD];
  __shared__ __align__(16) float vs[KC][HD];

  const int b = blockIdx.z, head = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < N;

  float qr[HD];
  {
    const float* qp = q + b * q_sb + (long long)(active ? row : 0) * q_sn + head * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(qp + d);
      qr[d] = t.x; qr[d + 1] = t.y; qr[d + 2] = t.z; qr[d + 3] = t.w;
    }
  }
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  const float* kb = k + b * k_sb + head * HD;
  const float* vb = v + b * v_sb + head * HD;
  for (int k0 = 0; k0 < Nk; k0 += KC) {
    const int kn = min(KC, Nk - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < kn * (HD / 4); i += kThreads) {
      const int key = i / (HD / 4), d = (i % (HD / 4)) * 4;
      *reinterpret_cast<float4*>(&ks[key][d]) =
          *reinterpret_cast<const float4*>(kb + (long long)(k0 + key) * k_sn + d);
      *reinterpret_cast<float4*>(&vs[key][d]) =
          *reinterpret_cast<const float4*>(vb + (long long)(k0 + key) * v_sn + d);
    }
    __syncthreads();
    for (int s0 = 0; s0 < kn; s0 += SUB) {
      const int sn = min(SUB, kn - s0);
      float s[SUB];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        float acc = -INFINITY;
        if (j < sn) {
          acc = 0.0f;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&ks[s0 + j][d]);
            acc += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
          }
          acc *= scale;
        }
        s[j] = acc;
        cmax = fmaxf(cmax, acc);
      }
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);  // 0 on the first batch (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] *= corr;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j < sn) {
          const float p = expf(s[j] - mnew);
          l += p;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(&vs[s0 + j][d]);
            o[d] += p * vv.x; o[d + 1] += p * vv.y; o[d + 2] += p * vv.z; o[d + 3] += p * vv.w;
          }
        }
      }
      m = mnew;
    }
  }
  if (!active) return;
  const float inv = 1.0f / l;
  float* op = out + ((long long)b * N + row) * C + head * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(op + d) =
        make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
}

}  // namespace

extern "C" int gsa_attention_f32(const float* q, const float* k, const float* v, float* out,
                                 int B, int N, int Nk, int num_heads, long long q_sb,
                                 long long q_sn, long long k_sb, long long k_sn,
                                 long long v_sb, long long v_sn, float scale, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || Nk < 1 || num_heads < 1 || num_heads > 65535)
    return -1;
  const dim3 grid((N + kThreads - 1) / kThreads, num_heads, B);
  gsa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, Nk, num_heads * HD, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, scale);
  return static_cast<int>(cudaGetLastError());
}
