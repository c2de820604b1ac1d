"""Time K2 `visibility_net` against its design alternatives on one GPU.

    python -m mvsformer_torch.k2_variants [--reps 20] [--rounds 3]

Each alternative is `csrc/vis_net.cu` with a few constants or lines
substituted, built with the kernels' own nvcc flags
(`mvsformer_torch.kernel_variants`): "as built" (16 x 16 tiles, MF = 3
layer-1 fragments per warp pass, weights read with __ldg, three blocks
per SM), "MF=2", "weights in smem" (each block copies the 6,912 packed
floats into shared memory: 99 KB a block, two per SM) and "16x32 tiles"
(131 KB a block, one per SM). Every one is held to
`visibility_net_plain` within 1e-5. Three probes, which compute wrong
numbers on purpose, say where the time goes: "probe: no split" (A taken
as hi = x, lo = x, the twelve instructions of each split gone), "probe:
1xTF32" (one mma per multiply-add step instead of three; the lo halves
of the split then fall away too) and "probe: no mma" (each 3xTF32 step
replaced by four FFMAs on the same operands, so the loads and splits
stay). All are timed by CUDA events at the four launch shapes of the DTU
eval request (4 source views of 144x192 up to 1152x1536), the main
kernel alone (the weights packed once, outside the timed launches), in
turns over several rounds. Prints the card, and for each alternative its
ptxas registers, spills and static shared memory, blocks per SM, and its
ms per stage and per request against the 0.394 ms tensor-core bound, one
JSON line each.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops.vis_net import launch, pack, visibility_net_plain

STAGES = ((144, 192), (288, 384), (576, 768), (1152, 1536))
N_VIEWS = 4
BOUND_MS = 0.394  # 3 x 2 x 3,456 multiply-adds per pixel over 494.7 TFLOP/s, per request

_SMEM_W = [
    ("constexpr int kSmemFloats = kOffParams + kParamsPad;",
     "constexpr int kOffW = kOffParams + kParamsPad;\n"
     "constexpr int kSmemFloats = kOffW + 6912;"),
    ("  float* sp = smem + kOffParams;\n",
     "  float* sp = smem + kOffParams;\n"
     "  float4* sw = reinterpret_cast<float4*>(smem + kOffW);\n"
     "  for (int i = threadIdx.x; i < 1152; i += kThreads) sw[i] = w1[i];\n"
     "  for (int i = threadIdx.x; i < 576; i += kThreads) sw[1152 + i] = w2[i];\n"),
    ("__ldg(w1 + ", "*(sw + "),
    ("__ldg(w2 + ", "*(sw + 1152 + "),
    ("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;"),
]
_PROBE_FNS = """
__device__ __forceinline__ void nosplit_a(float2 x0, float2 x1, uint32_t* ah, uint32_t* al) {
  ah[0] = al[0] = __float_as_uint(x0.x);
  ah[1] = al[1] = __float_as_uint(x1.x);
  ah[2] = al[2] = __float_as_uint(x0.y);
  ah[3] = al[3] = __float_as_uint(x1.y);
}
__device__ __forceinline__ void mma_1xtf32(float* d, const uint32_t* ah, const uint32_t* al,
                                           float4 b) {
  mma_tf32(d, ah, b.x, b.y);
}
__device__ __forceinline__ void fake_mma(float* d, const uint32_t* ah, const uint32_t* al,
                                         float4 b) {
  d[0] += __uint_as_float(ah[0]) * b.x + __uint_as_float(al[1]) * b.z;
  d[1] += __uint_as_float(ah[2]) * b.y + __uint_as_float(al[3]) * b.w;
  d[2] += __uint_as_float(ah[1]) * b.x + __uint_as_float(al[0]) * b.z;
  d[3] += __uint_as_float(ah[3]) * b.y + __uint_as_float(al[2]) * b.w;
}
"""
_ANCHOR = "__device__ __forceinline__ float2 ld2(const float* p) {"


def _probe(old, new):
    return [(_ANCHOR, _PROBE_FNS + _ANCHOR), (old, new)]


VARIANTS = {
    "as built": [],
    "MF=2": [("constexpr int MF = 3;", "constexpr int MF = 2;")],
    "weights in smem": _SMEM_W,
    "16x32 tiles": [("constexpr int TH = 16, TW = 16;", "constexpr int TH = 16, TW = 32;"),
                    ("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 1;")],
    "probe: no split": _probe("split_a(ld2", "nosplit_a(ld2"),
    "probe: 1xTF32": _probe("mma_3xtf32(part", "mma_1xtf32(part"),
    "probe: no mma": _probe("mma_3xtf32(part", "fake_mma(part"),
}


def weights(rng, dev):
    """K2's weights at the model's scale (as tests/test_torch_cuda.py draws them)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((16, 1, 3, 3), 9 ** -0.5), ((16, 16, 3, 3), 144 ** -0.5), ((8, 16, 3, 3), 144 ** -0.5))]
    folds = [(t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)))
             for c in (16, 16, 8)]
    return (*ks, t(rng.standard_normal((1, 8, 1, 1)) * 0.35), t(rng.standard_normal(1) * 0.1),
            folds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    print(f"card: {name_limit}")
    built = build_all("vis_net", VARIANTS)
    rng = np.random.default_rng(0)
    w = weights(rng, "cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ents = [torch.from_numpy(rng.uniform(0, 3.5, (N_VIEWS, h, wd)).astype(np.float32)).cuda()
            for h, wd in STAGES]
    times = {name: [[] for _ in STAGES] for name in built}
    errs = {}
    packed = {}
    for name, (lib, _) in list(built.items()):
        packed[name] = pack(lib, *w, stream)
        errs[name] = max(float((launch(lib, e, packed[name], stream)
                                - visibility_net_plain(e, *w)).abs().max()) for e in ents)
        if errs[name] > 1e-5 and not name.startswith("probe"):
            print(f"{name!r} disagrees with the plain version by {errs[name]:.3e}; left out")
            del built[name]
    names = list(built)
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:  # in turns
            lib = built[name][0]
            for s, e in enumerate(ents):
                times[name][s].append(
                    time_ms(lambda: launch(lib, e, packed[name], stream), args.reps))
    for name, (lib, report) in built.items():
        per_stage = [min(ts) for ts in times[name]]
        total = sum(per_stage)
        print(json.dumps({
            "variant": name, "ptxas": ptxas_summary(report),
            "blocks_per_sm": lib.visibility_net_blocks_per_sm(),
            "max_abs_err": errs[name],
            "ms_per_stage_min": [round(t, 4) for t in per_stage],
            "ms_per_stage_all_rounds": [[round(t, 4) for t in ts] for ts in times[name]],
            "ms_per_request": round(total, 4), "share_of_bound": round(BOUND_MS / total, 4),
            "card": name_limit}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
