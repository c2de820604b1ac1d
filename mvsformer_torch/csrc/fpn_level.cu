// K5: one top-down FPN level in one launch, the 3x3 conv on the tensor cores.
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
// Bound on the H100: the 3x3 conv is 90% of the operations (per output
// pixel 2 * 576 * CO flop, against 2 * 64 * CL for the 1x1). Run as 3xTF32
// on the tensor cores (three TF32 products per multiply-add, 494.7 TFLOP/s
// dense), it bounds levels 1 and 3 (0.124 and 0.495 ms at the DTU request,
// 5 views); level 2, which also writes the 64-channel intra', is bound by
// its bytes (0.296 ms). The 64-channel intra', up2(intra_prev) and
// conv1x1(lateral) never reach device memory unless intra' is asked for.
//
// Design: one block of 8 warps per 16 x 16 output tile, for all CO channels.
//  - The parameters of the 1x1 conv, the biases and the folded BN (at most
//    2,208 floats) sit in shared memory. The 3x3 weights do not: the
//    wrapper splits them into TF32 hi and lo parts and packs both in mma
//    B-fragment order (ops/fpn_level.py pack_k3), so a lane fetches its
//    (hi, hi, lo, lo) of one fragment with one 16-byte __ldg; the packed
//    weights (36.9K floats at CO = 32) stay in L2 and L1 for every block.
//  - Phase 1 computes intra' over the tile with a 1-pixel halo, 18 x 18
//    pixels, into shared memory, pixel-major with 64 channels innermost
//    and a pixel stride of PS = 72 floats. A thread forms a horizontal
//    pixel pair: with the align-corners scale below 1/2, pixels 2k - 1 and
//    2k read the same source column, so each tap is loaded once for both
//    (this halved the gathers; 162 of the 256 threads work). It reads each
//    pixel's CL lateral values once and forms all 64 channels, as
//    up + (conv1x1 + b1). Positions outside the image are exact zeros: the
//    3x3 conv pads intra', not intra_prev. The align-corners source
//    coordinate and its weight are computed as PyTorch's
//    upsample_bilinear2d computes them (scale = float(h-1) / (2h-1),
//    src = scale * i, truncated), so the kernel and the plain version
//    interpolate with the same weights.
//  - Phase 2 is the 3x3 conv as an implicit GEMM: M = the tile's 256
//    pixels, N = CO, K = 64 channels x 9 taps, on
//    mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. A warp owns RW output
//    rows (16-pixel M fragments) and all CO / 8 N fragments: RW = 2, and
//    4 at CO = 8, where 4 of the 8 warps then do all of it and each B
//    fragment serves four M fragments. Within a chunk of 8 input channels,
//    K is ordered so that a lane's two A values (columns t and t + 4) are
//    channels 2t and 2t + 1: one 8-byte shared load, and PS = 72 (8 mod 32
//    banks) puts the 16 lanes of each half-warp on distinct banks. A is
//    split into hi = tf32(x) and lo = tf32(x - hi) as it is loaded, and
//    each multiply-add is lo*hi + hi*lo + hi*hi (3xTF32): fp32's accuracy,
//    where one TF32 product keeps about 3 decimal digits. The tensor
//    cores round each mma's sum toward zero, so each chunk of 72 products
//    is summed from zero and then added to the fp32 accumulator. Each
//    intra' row (of the RW + 2 a warp reads) is loaded and split once per
//    (chunk, kx), for every output row that reads it. There is no split-K.
//  - Shared memory: 4 * (params + 18 * 18 * 72) bytes = 102,144 B at
//    (CL, CO) = (32, 32), 97,856 B at (16, 16) and 95,712 B at (8, 8).
//    With at most 128 registers a thread (__launch_bounds__(256, 2)) two
//    blocks share an SM at every level (fpn_level_blocks_per_sm reports
//    what the card makes of it), so one block's phase 1 can run beside the
//    other's phase 2; both lean on the same shared-memory and L1 path.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TH = 16, TW = 16;          // output tile; an M fragment is 16 pixels of a row
constexpr int SH = TH + 2, SW = TW + 2;   // intra' tile (1-pixel halo)
constexpr int kPix = SH * SW;
constexpr int PS = 72;                    // floats per intra' pixel: 64 channels and 8 of padding
static_assert(TW % 2 == 0, "phase 1's pixel pairs (2k - 1, 2k) start at odd image columns");

template <int CL, int CO>
struct Level {
  // Parameter layout in shared memory (floats), built by the Python wrapper.
  static constexpr int W1 = 0;              // [64][CL]
  static constexpr int B1 = W1 + 64 * CL;   // [64]
  static constexpr int B3 = B1 + 64;        // [CO]
  static constexpr int MU = B3 + CO;        // [CO] folded BN scale
  static constexpr int AD = MU + CO;        // [CO] folded BN shift
  static constexpr int kParams = AD + CO;
  static constexpr int NF = CO / 8;         // N fragments
  static constexpr size_t kSmemBytes = sizeof(float) * (kParams + kPix * PS);
  static_assert(CL % 4 == 0 && CO % 8 == 0 && kParams % 4 == 0, "float4 layout");
};

// The A fragment of 8 channels of two 8-pixel groups, split into hi and lo:
// pixel g's channels 2t and 2t + 1 (rows g), pixel g + 8's (rows g + 8).
__device__ __forceinline__ void load_a(const float* pa, uint32_t* ah, uint32_t* al) {
  split_a(*reinterpret_cast<const float2*>(pa), *reinterpret_cast<const float2*>(pa + 8 * PS),
          ah, al);
}

template <int CL, int CO>
__global__ void __launch_bounds__(kThreads, 2)
fpn_level_kernel(const float* __restrict__ prev,    // [N, 64, h, w]
                 const float* __restrict__ lat,     // [N, CL, 2h, 2w]
                 const float* __restrict__ params,  // [Level::kParams]
                 const float4* __restrict__ wpk,    // [8 chunks][9 taps][NF][32 lanes]
                 float* __restrict__ out,           // [N, CO, 2h, 2w]
                 float* __restrict__ intra_out,     // [N, 64, 2h, 2w] or null
                 int h, int w, float rh, float rw) {
  using L = Level<CL, CO>;
  constexpr int NF = L::NF;
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

  // Phase 1: intra' over the tile with a 1-pixel halo. A thread forms the
  // horizontal pixel pair (2k - 1, 2k), which shares its source column
  // x0 = k - 1 (the align-corners scale is below 1/2), so each of the four
  // taps is loaded once for both; it reads each pixel's lateral values once.
  constexpr int kPairs = SH * (SW / 2);
  for (int i = tid; i < kPairs; i += kThreads) {
    const int r = i / (SW / 2), c = 2 * (i - r * (SW / 2));
    const int gy = ty0 - 1 + r, gxa = tx0 - 1 + c, gxb = gxa + 1;
    float4* da = reinterpret_cast<float4*>(s_i + (r * SW + c) * PS);
    float4* db = da + PS / 4;
    const bool rowin = gy >= 0 && gy < H;
    const bool ina = rowin && gxa >= 0 && gxa < W, inb = rowin && gxb < W;
    if (!ina && !inb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) da[j] = db[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float sy = __fmul_rn(rh, (float)gy);
    const int y0 = (int)sy;
    const size_t dy = y0 < h - 1 ? (size_t)w : 0;
    const float ly1 = __fsub_rn(sy, (float)y0), ly0 = __fsub_rn(1.0f, ly1);
    const int gxv = ina ? gxa : gxb;  // a pixel of the pair inside the image
    const int x0 = (int)__fmul_rn(rw, (float)gxv);
    const int dx = x0 < w - 1 ? 1 : 0;
    const float la1 = __fsub_rn(__fmul_rn(rw, (float)gxa), (float)x0), la0 = __fsub_rn(1.0f, la1);
    const float lb1 = __fsub_rn(__fmul_rn(rw, (float)gxb), (float)x0), lb0 = __fsub_rn(1.0f, lb1);

    float lta[CL], ltb[CL];
    const float* lp = lat + (size_t)n * CL * HW + (size_t)gy * W + gxa;
#pragma unroll
    for (int j = 0; j < CL; ++j) {
      lta[j] = ina ? lp[j * HW] : 0.0f;
      ltb[j] = inb ? lp[j * HW + 1] : 0.0f;
    }
    const bool emit = intra_out != nullptr && r >= 1 && r <= TH;
    const bool ea = emit && ina && c >= 1, eb = emit && inb && c + 1 <= TW;
    const float* p00 = prev + (size_t)n * 64 * hw + (size_t)y0 * w + x0;
#pragma unroll 2
    for (int q = 0; q < 16; ++q) {
      float va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = q * 4 + j;
        const float* pc = p00 + ch * hw;
        const float t00 = pc[0], t01 = pc[dx], t10 = pc[dy], t11 = pc[dy + dx];
        const float upa = ly0 * (la0 * t00 + la1 * t01) + ly1 * (la0 * t10 + la1 * t11);
        const float upb = ly0 * (lb0 * t00 + lb1 * t01) + ly1 * (lb0 * t10 + lb1 * t11);
        float acca = 0.0f, accb = 0.0f;
#pragma unroll
        for (int k = 0; k < CL; k += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(sp + L::W1 + ch * CL + k);
          acca += wv.x * lta[k] + wv.y * lta[k + 1] + wv.z * lta[k + 2] + wv.w * lta[k + 3];
          accb += wv.x * ltb[k] + wv.y * ltb[k + 1] + wv.z * ltb[k + 2] + wv.w * ltb[k + 3];
        }
        const float b1 = sp[L::B1 + ch];
        va[j] = ina ? upa + (acca + b1) : 0.0f;
        vb[j] = inb ? upb + (accb + b1) : 0.0f;
        float* io = intra_out + ((size_t)n * 64 + ch) * HW + (size_t)gy * W + gxa;
        if (ea) io[0] = va[j];
        if (eb) io[1] = vb[j];
      }
      da[q] = make_float4(va[0], va[1], va[2], va[3]);
      db[q] = make_float4(vb[0], vb[1], vb[2], vb[3]);
    }
  }
  __syncthreads();

  // Phase 2: the 3x3 conv as an implicit GEMM on the tensor cores. A warp
  // owns RW output rows: two, or four at CO = 8, where each B fragment
  // then serves four M fragments and only half of the warps run this phase.
  constexpr int RW = NF == 1 ? 4 : 2;
  static_assert(RW * (kThreads / 32) >= TH, "the warps cover the tile's rows");
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = RW * warp;  // the warp's first output row in the tile
  if (r0 >= TH || ty0 + r0 >= H) return;
  float acc[RW][NF][4];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][f][e] = 0.0f;

  // A fragment rows g and g + 8 are pixels g and g + 8 of an intra' row;
  // a lane reads channels 2t and 2t + 1 of its chunk.
  const float* s_a = s_i + (r0 * SW + g) * PS + 2 * t;
  const float4* wq = wpk + lane;
#pragma unroll 1
  for (int ck = 0; ck < 8; ++ck) {
    // The tensor cores round the fp32 sum of each mma toward zero, so a
    // long chain of them drifts: over all 576 products it ended several
    // times less accurate than the FFMA body it replaced. A chunk's 72
    // products are summed from zero and added to acc in round-to-nearest,
    // which keeps the error near fp32's.
    float part[RW][NF][4];
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][f][e] = 0.0f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      // Output row r0 + j at tap (ky, kx) reads intra' row R = r0 + j + ky:
      // each of the RW + 2 intra' rows is loaded and split once, at its
      // first use, for the up to three (j, ky) that read it.
      const float* pa = s_a + kx * PS + ck * 8;
      uint32_t ah[RW + 2][4], al[RW + 2][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float4 b[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) b[f] = __ldg(wq + ((ck * 9 + ky * 3 + kx) * NF + f) * 32);
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const int R = j + ky;
          if (ky == 0 || j == RW - 1) load_a(pa + R * SW * PS, ah[R], al[R]);
#pragma unroll
          for (int f = 0; f < NF; ++f) mma_3xtf32(part[j][f], ah[R], al[R], b[f]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][f][e] += part[j][f][e];
  }

  // Epilogue: bias, folded BN, swish. Accumulator e of fragment f holds
  // pixel g + 8 * (e / 2), channel 8f + 2t + e % 2.
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int gy = ty0 + r0 + j;
    if (gy >= H) continue;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gx = tx0 + g + 8 * (e >> 1);
        const int oc = 8 * f + 2 * t + (e & 1);
        if (gx >= W) continue;
        const float z = (acc[j][f][e] + sp[L::B3 + oc]) * sp[L::MU + oc] + sp[L::AD + oc];
        out[((size_t)n * CO + oc) * HW + (size_t)gy * W + gx] = z * (1.0f / (1.0f + expf(-z)));
      }
    }
  }
}

template <int CL, int CO>
int launch(const float* prev, const float* lat, const float* params, const float* wpk,
           float* out, float* intra_out, int N, int h, int w, cudaStream_t stream) {
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
      prev, lat, params, reinterpret_cast<const float4*>(wpk), out, intra_out, h, w, rh, rw);
  return static_cast<int>(cudaGetLastError());
}

template <int CL, int CO>
int blocks_per_sm() {
  using L = Level<CL, CO>;
  cudaError_t err = cudaFuncSetAttribute(fpn_level_kernel<CL, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kSmemBytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fpn_level_kernel<CL, CO>,
                                                        kThreads, L::kSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" int fpn_level_f32(const float* prev, const float* lat, const float* params,
                             const float* wpk, float* out, float* intra_out, int N, int h,
                             int w, int cl, int co, void* stream) {
  if (N < 1 || N > 65535 || h < 1 || w < 1 || (2 * h + TH - 1) / TH > 65535) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cl == 32 && co == 32) return launch<32, 32>(prev, lat, params, wpk, out, intra_out, N, h, w, s);
  if (cl == 16 && co == 16) return launch<16, 16>(prev, lat, params, wpk, out, intra_out, N, h, w, s);
  if (cl == 8 && co == 8) return launch<8, 8>(prev, lat, params, wpk, out, intra_out, N, h, w, s);
  return -1;
}

// Resident blocks per SM of the level's kernel (negative: a CUDA error), for
// the occupancy the design note promises.
extern "C" int fpn_level_blocks_per_sm(int cl, int co) {
  if (cl == 32 && co == 32) return blocks_per_sm<32, 32>();
  if (cl == 16 && co == 16) return blocks_per_sm<16, 16>();
  if (cl == 8 && co == 8) return blocks_per_sm<8, 8>();
  return -1;
}
