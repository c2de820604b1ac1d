"""Time K4 `encoder_head` against probes and design alternatives on one GPU.

    python -m mvsformer_torch.k4_variants [--reps 10] [--rounds 3] [--parent DIR]

Each variant is `csrc/encoder_head.cu` with a few lines substituted, built
with the kernels' own nvcc flags (`mvsformer_torch.kernel_variants`), and
timed by CUDA events, the kernel alone (the weights packed once, outside
the timed launches), at K4's launch shape in the DTU eval request (5 views
of 3 x 1152 x 1536), in turns over several rounds. The weights are
`chip_smoke.py`'s (`build_model` at the default `ModelConfig`, filled by
`random_init_` from seed 0), the images standard normal from seed 0.
Probes compute wrong numbers on purpose; every other variant is held to
`encoder_head_plain` within 1e-4 of each output's scale.

Variants of the design as built (`VARIANTS`): "split once, hi and lo in
shared memory" (conv00's and conv01's outputs split in their epilogues,
twice the bytes, one block per SM), "split by cvt.rna" (activations split
to nearest where read, as tf32_mma.cuh's split_tf32), fewer rows a work
item ("conv00 RW0=2", "conv01 RW1=4"), and the probes "1xTF32" (one mma
per step instead of three), "no halo" (conv00 and conv01 over about the
tile's own rows and columns), each layer alone and the image load alone.

With `--parent DIR` (a checkout of the tree before K4 ran on the tensor
cores, e.g. `git archive 2546c22 | tar -x -C scratch_chip/parent`) it
also builds that tree's FFMA kernel and its probes (`PARENT_VARIANTS`):
"no halo" (conv00 and conv01 over the 16 x 32 tile only), "conflict-free
loads" (every activation row read at lane-consecutive addresses), each of
conv00, conv01 and down0 alone, and the image load (with conv01's store)
alone.

It also measures what `mma.sync.m16n8k8` TF32 sustains on the card: a
kernel of register operands only, eight independent accumulators a warp,
no loads, at 4 to 32 warps per SM.

Prints the card, then one JSON line per variant (ptxas registers, spills
and static shared memory, resident blocks per SM where the source reports
them, the error against the plain version, ms of each round and their
least, its share of the 0.384 ms tensor-core bound and of the 0.952 ms
FFMA bound), then one line per mma rate configuration.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.encoder_head import encoder_head_plain, launch, pack

N_VIEWS, H, W = 5, 1152, 1536
# Per request: 3 x 2 x 31.64 G multiply-adds over 494.7 TFLOP/s (3xTF32 on
# the tensor cores), and 2 x 31.64 G over 67 TFLOP/s (fp32 FFMA).
TENSOR_BOUND_MS, FFMA_BOUND_MS = 0.384, 0.952

# The design as built: every conv a 3xTF32 implicit GEMM on mma.sync, the
# activations fp32 in shared memory and split where they are read, a work
# item RW rows of a 16-pixel fragment (each A fragment loaded once for every
# kernel row that reads it) or SF fragments of the region's last columns.
_SKIP_A = ("u < kRowItems0 + kStripItems0;", "u < 0;")
_SKIP_B = ("u < kRowItems1 + kStripItems1;", "u < 0;")
_SKIP_D = ("      for (int ky = 0; ky < 5; ++ky) {\n        const int tap = ky * 5 + kx;",
           "      for (int ky = 0; ky < 0; ++ky) {\n        const int tap = ky * 5 + kx;")
_STORE = "  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);\n"
_LOAD = "  split_a_trunc(ld2(p0), ld2(p1), ah, al);\n"
# conv00's and conv01's outputs split once, in the epilogue that makes them:
# (hi, hi, lo, lo) of channels 2t and 2t + 1 at 4t of a 16-float pixel, so
# a fragment row is one 16-byte load and no split (twice the bytes).
_SPLIT_ONCE = [
    ("constexpr int PS = 8; ", "constexpr int PS = 16; "),
    (_STORE, "  uint32_t h0, l0, h1, l1;\n  split_tf32(v0, h0, l0);\n  split_tf32(v1, h1, l1);\n"
             "  *reinterpret_cast<float4*>(p) = make_float4(__uint_as_float(h0), __uint_as_float(h1),\n"
             "                                              __uint_as_float(l0), __uint_as_float(l1));\n"),
    (_LOAD, "  const float4 x0 = *reinterpret_cast<const float4*>(p0);\n"
            "  const float4 x1 = *reinterpret_cast<const float4*>(p1);\n"
            "  ah[0] = __float_as_uint(x0.x); ah[1] = __float_as_uint(x1.x);\n"
            "  ah[2] = __float_as_uint(x0.y); ah[3] = __float_as_uint(x1.y);\n"
            "  al[0] = __float_as_uint(x0.z); al[1] = __float_as_uint(x1.z);\n"
            "  al[2] = __float_as_uint(x0.w); al[3] = __float_as_uint(x1.w);\n"),
]
_TRUNC = ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
          "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;\n")
_MMA1_FN = ("__device__ __forceinline__ void mma_1xtf32(float* d, const uint32_t* ah, "
            "const uint32_t* al, float4 b) {\n  mma_tf32(d, ah, b.x, b.y);\n}\n\n")
_LRELU = "__device__ __forceinline__ float lrelu(float x)"

VARIANTS = {
    "as built": [],
    "split once, hi and lo in shared memory": _SPLIT_ONCE,
    "split by cvt.rna": [(_TRUNC, "  split_tf32(x, hi, lo);\n")],
    "conv00 RW0=2": [("constexpr int RW0 = 3,", "constexpr int RW0 = 2,")],
    "conv01 RW1=4": [("constexpr int RW1 = 5,", "constexpr int RW1 = 4,")],
    "probe: 1xTF32": [(_LRELU, _MMA1_FN + _LRELU), (" mma_3xtf32(part", " mma_1xtf32(part")],
    "probe: no halo": [("u < kRowItems0 + kStripItems0;", "u < (TH + RW0 - 1) / RW0 * CF;"),
                       ("u < kRowItems1 + kStripItems1;", "u < (TH + RW1 - 1) / RW1 * CF;")],
    "probe: conv00 only": [_SKIP_B, _SKIP_D],
    "probe: conv01 only": [_SKIP_A, _SKIP_D],
    "probe: down0 only": [_SKIP_A, _SKIP_B],
    "probe: image load only": [_SKIP_A, _SKIP_B, _SKIP_D],
}

# The FFMA kernel of the parent tree (one block per 16 x 32 tile, conv00
# over 24 x 40 pixels, conv01 over 20 x 36, register blocking of 4 pixels
# x 8 channels a thread) and its probes.
_CONV00 = "  conv_to_smem<3, 7, AH, AW, IH, IW>("
_CONV01 = "  conv_to_smem<8, 5, BH, BW, AH, AW>("
_DOWN0 = "  for (int it = tid; it < 2 * DH * DW; it += kThreads) {"
_SKIP = {_CONV00: "  if (0) conv_to_smem<3, 7, AH, AW, IH, IW>(",
         _CONV01: "  if (0) conv_to_smem<8, 5, BH, BW, AH, AW>(",
         _DOWN0: "  for (int it = tid; it < 0; it += kThreads) {"}


def _only(*keep):
    return [(old, new) for old, new in _SKIP.items() if old not in keep]


PARENT_VARIANTS = {
    "as built": [],
    "probe: no halo": [("conv_to_smem<3, 7, AH, AW,", "conv_to_smem<3, 7, TH, TW,"),
                       ("conv_to_smem<8, 5, BH, BW,", "conv_to_smem<8, 5, TH, TW,")],
    "probe: conflict-free loads": [
        ("(r + ky) * SW + c0;", "(r + ky) * SW + (threadIdx.x & 31);"),
        ("(2 * r + ky) * BW + 2 * c;", "(2 * r + ky) * BW + (threadIdx.x & 15);")],
    "probe: conv00 only": _only(_CONV00),
    "probe: conv01 only": _only(_CONV01),
    "probe: down0 only": _only(_DOWN0),
    "probe: image load and conv01 store only": _only(),
}

MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32_mma.cuh"

constexpr int kChains = 8;  // independent accumulators a warp

__global__ void mma_rate_kernel(float* out, int iters) {
  const float s = 1.0f + 1e-3f * (float)threadIdx.x;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(s + (float)i) & 0xffffe000u;
  const float b0 = __uint_as_float(__float_as_uint(0.5f * s) & 0xffffe000u);
  const float b1 = __uint_as_float(__float_as_uint(0.25f * s) & 0xffffe000u);
  float d[kChains][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[c][e] = 0.0f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_tf32(d[c], a, b0, b1);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate(float* out, int blocks, int threads, int iters, void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
MMA_CHAINS = 8


def mma_rate(reps: int) -> list:
    """[{warps_per_sm, ms, tflops}]: m16n8k8 TF32 mma.sync issued back to
    back on register operands, one to four blocks per SM."""
    out_dir = cuda_build.BUILD_DIR / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(MMA_RATE_SOURCE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows, iters = [], 2048
    for per_sm, threads in ((1, 128), (1, 256), (2, 256), (4, 256)):
        blocks = sms * per_sm
        out = torch.empty(blocks * threads, device="cuda")
        run = lambda: cuda_build.check_launch(
            lib.mma_rate(out.data_ptr(), blocks, threads, iters, stream), "mma_rate")
        ms = time_ms(run, reps)
        flops = blocks * (threads // 32) * iters * MMA_CHAINS * 2 * 16 * 8 * 8
        rows.append({"warps_per_sm": int(per_sm * threads // 32), "ms": round(ms, 4),
                     "tflops": round(flops / ms / 1e9, 2)})
    return rows


def head_weights(dev):
    """K4's weights as chip_smoke.py's model holds them: the default
    `ModelConfig`, filled by `random_init_` from seed 0."""
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    model = build_model(ModelConfig(), device=dev)
    random_init_(model, torch.Generator().manual_seed(0))
    enc = model.encoder
    with torch.no_grad():
        return tuple(t.detach().clone() for t in (
            enc.conv00.conv.weight, *enc.conv00.bn.folded(), enc.conv01.conv.weight,
            *enc.conv01.bn.folded(), enc.downsample1.conv.weight, *enc.downsample1.bn.folded()))


def parent_params(flat):
    """The parent kernel's parameters: conv weights as [ci][ky][kx][o],
    each followed by its folded BN."""
    k00, m00, a00, k01, m01, a01, kd, md, ad = flat
    return torch.cat([t.float().reshape(-1) for t in (
        k00.permute(1, 2, 3, 0), m00, a00, k01.permute(1, 2, 3, 0), m01, a01,
        kd.permute(1, 2, 3, 0), md, ad)]).contiguous()


def current_params(lib, flat, stream):
    k00, m00, a00, k01, m01, a01, kd, md, ad = flat
    return pack(lib, k00, (m00, a00), k01, (m01, a01), kd, (md, ad), stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the tree with the FFMA kernel, to time it and its probes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    sets = {"": (VARIANTS, cuda_build.CSRC, current_params)}
    if args.parent is not None:
        sets["parent: "] = (PARENT_VARIANTS, args.parent / "mvsformer_torch" / "csrc",
                            lambda lib, flat, stream: parent_params(flat))
    built = {}
    for prefix, (variants, csrc, params) in sets.items():
        for name, entry in build_all("encoder_head", variants, csrc).items():
            built[prefix + name] = (*entry, params)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(np.ascontiguousarray(
        rng.standard_normal((N_VIEWS, H, W, 3)).astype(np.float32).transpose(0, 3, 1, 2))).cuda()
    flat = head_weights("cuda")
    k00, m00, a00, k01, m01, a01, kd, md, ad = flat
    want = encoder_head_plain(imgs, k00, (m00, a00), k01, (m01, a01), kd, (md, ad))
    stream = torch.cuda.current_stream().cuda_stream
    params, errs = {}, {}
    for name, (lib, _, make) in list(built.items()):
        params[name] = make(lib, flat, stream)
        got = launch(lib, imgs, params[name], stream)
        errs[name] = max(float((g - w_).abs().max()) / max(1.0, float(w_.abs().max()))
                         for g, w_ in zip(got, want))
        if errs[name] > 1e-4 and "probe" not in name:
            print(f"{name!r} disagrees with the plain version by {errs[name]:.3e} of scale; "
                  "left out")
            del built[name]
    del want
    names = list(built)
    times = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:  # in turns
            lib = built[name][0]
            times[name].append(time_ms(lambda: launch(lib, imgs, params[name], stream),
                                       args.reps))
    for name in names:
        lib, report, _ = built[name]
        ms = min(times[name])
        blocks = (lib.encoder_head_blocks_per_sm()
                  if hasattr(lib, "encoder_head_blocks_per_sm") else None)
        print(json.dumps({
            "variant": name, "ptxas": ptxas_summary(report), "blocks_per_sm": blocks,
            "max_err_of_scale": errs[name], "ms_all_rounds": [round(t, 4) for t in times[name]],
            "ms": round(ms, 4), "share_of_tensor_bound": round(TENSOR_BOUND_MS / ms, 4),
            "share_of_ffma_bound": round(FFMA_BOUND_MS / ms, 4), "card": name_limit}),
            flush=True)
    for row in mma_rate(args.reps):
        print(json.dumps({"probe": "mma.sync m16n8k8 tf32, registers only", **row,
                          "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
