"""Time K8 `warp_corr_bwd` against probes and design alternatives on one GPU.

    python -m mvsformer_torch.k8_variants [--reps 20] [--rounds 3]

Each variant is `csrc/warp_corr_bwd.cu` with a few lines substituted,
built with the kernels' own nvcc flags (`mvsformer_torch.kernel_variants`).
Variants of the design as built (C/4 lanes a pixel, two at C = 8; taps and
cotangents once per (pixel, depth) in shared memory; dsrc summed in
registers while a pixel's taps stay on one square of source pixels, then
one 16-byte vector reduction per tap and lane):

- "no sums over depths": every depth adds its taps to dsrc.
- "shared-memory window": dsrc accumulated per block in a 16 KB window
  over the box of source pixels its taps touch (shared fp32 atomics, a
  pixel's channels at a padded stride so neighbouring pixels meet no bank
  conflict), flushed with one vector reduction per non-zero float4; taps
  outside the window go straight to global. "window per depth" flushes it
  after every depth, "window without padding" drops the padding.
- "C = 8 per-pixel threads": one thread per pixel at C = 8.
- "4 blocks per SM", "5 blocks per SM", "chunks of 256 pairs": registers
  capped for four or five blocks; half the depths a chunk.
- "probe: no dsrc scatter", "probe: dsrc as plain stores": the reductions
  into dsrc removed, or made plain 16-byte stores to the same addresses.

Variants of K8's first mapping, one thread per pixel in blocks of 128 and
one scalar atomicAdd per (depth, tap, channel) into dsrc, run through this
body ("per-pixel threads, scalar atomics"), and its probes: the scatter
removed, made plain scalar stores, or made one float4 atomic per 4
channels ("vector atomics (per-pixel threads)").

The probes compute wrong numbers on purpose; every other variant is held
to `warp_corr_bwd_plain` (dref and dsrc within 1e-5 of their scale). All
are timed by CUDA events, the kernel alone (the relative projection
computed once outside, dref and dsrc zeroed once: the timed launches add
into them), at the four K8 launch shapes of a training micro-batch (B=4,
4 source views, 64x80 with C=64, D=32 up to 512x640 with C=8, D=4), in
turns over several rounds, with the synthetic cameras of `chip_smoke.py`
and depths spread over 425-900 at every pixel. Prints the card, then for
each variant its ptxas registers, spills and static shared memory,
resident blocks per SM and its ms per stage (the least of the rounds),
one JSON line each.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mvsformer_torch.k1_variants import K7_STAGES as K8_STAGES
from mvsformer_torch.k1_variants import inputs
from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops.warp_corr import relative_rows
from mvsformer_torch.ops.warp_corr_train import warp_corr_bwd_plain

_SCATTER = ("          if (any) red_global4(dsrcv + o * C + (j * NV + n) * 4, "
            "times_groups<NE>(r[n], s));\n")
_NO_SCATTER = [(_SCATTER, "          (void)any;\n")]
_PLAIN_STORES = [(_SCATTER, "          if (any) *reinterpret_cast<float4*>(dsrcv + o * C + "
                            "(j * NV + n) * 4) = times_groups<NE>(r[n], s);\n")]
# Every depth adds its taps: no sums over depths that share a square.
_NO_PENDING = [("if (xy.x != sq.x || xy.y != sq.y || xy.z != sq.z || xy.w != sq.w) {", "{")]
_LANES = "__host__ __device__ constexpr int lanes_per_pixel(int C) { return C / 4; }"
_RED = "  atomicAdd(reinterpret_cast<float4*>(p), v);\n"
# K8's first mapping: one thread per pixel, 128 threads a block, a scalar
# atomicAdd per (depth, tap, channel).
_PER_PIXEL = [(_LANES, _LANES.replace("C / 4", "1")),
              ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")] + _NO_PENDING
_SCALAR_RED = [(_RED, "  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n"
                      "  atomicAdd(p + 2, v.z);\n  atomicAdd(p + 3, v.w);\n")]
_SCALAR_STORES = [(_RED, "  p[0] = v.x;\n  p[1] = v.y;\n  p[2] = v.z;\n  p[3] = v.w;\n")]

# The shared-memory dsrc window: the box of the chunk's non-zero taps, cut
# to 4096 floats, a source pixel's channels as four rows of C/4 floats (one
# per float4 component) at a stride of C + C/4.
_WINDOW = [
    ("#include <math.h>\n", "#include <limits.h>\n#include <math.h>\n"),
    ("size_t smem_bytes(int C, int D) {",
     "constexpr int kWindowFloats = 4096;\n"
     "__host__ __device__ constexpr int window_stride(int C) { return C + C / 4; }\n\n"
     "size_t smem_bytes(int C, int D) {"),
    ("  return sizeof(float) * ((size_t)8 * pairs + (size_t)G * group_stride(pairs));",
     "  return sizeof(float) * ((size_t)8 * pairs + (size_t)G * group_stride(pairs) +\n"
     "                          kWindowFloats) + sizeof(int) * 4 * (kThreads / 32);"),
    ("  float* s_e = reinterpret_cast<float*>(smem4 + 2 * pairs);  // [G][GS]\n",
     "  float* s_e = reinterpret_cast<float*>(smem4 + 2 * pairs);  // [G][GS]\n"
     "  constexpr int WS = window_stride(C);\n"
     "  constexpr int kEntries = kWindowFloats / WS;\n"
     "  constexpr int kWarps = kThreads / 32;\n"
     "  float* s_win = s_e + G * GS;\n"
     "  int* s_box = reinterpret_cast<int*>(s_win + kWindowFloats);\n"),
    ("    for (int i = threadIdx.x; i < nd * TP; i += kThreads) {\n"
     "      const int pp = p0 + i % TP;\n",
     "    int x_lo = INT_MAX, x_hi = INT_MIN, y_lo = INT_MAX, y_hi = INT_MIN;\n"
     "    for (int i = threadIdx.x; i < nd * TP; i += kThreads) {\n"
     "      const int pp = p0 + i % TP;\n"),
    ("      s_w[i] = s.w;\n      s_xy[i] = s.xy;\n    }\n    __syncthreads();\n",
     "      s_w[i] = s.w;\n      s_xy[i] = s.xy;\n"
     "      if (s.w.x != 0.0f || s.w.z != 0.0f) x_lo = min(x_lo, s.xy.x), "
     "x_hi = max(x_hi, s.xy.x);\n"
     "      if (s.w.y != 0.0f || s.w.w != 0.0f) x_lo = min(x_lo, s.xy.y), "
     "x_hi = max(x_hi, s.xy.y);\n"
     "      if (s.w.x != 0.0f || s.w.y != 0.0f) y_lo = min(y_lo, s.xy.z), "
     "y_hi = max(y_hi, s.xy.z);\n"
     "      if (s.w.z != 0.0f || s.w.w != 0.0f) y_lo = min(y_lo, s.xy.w), "
     "y_hi = max(y_hi, s.xy.w);\n"
     "    }\n"
     "    x_lo = __reduce_min_sync(0xffffffffu, x_lo);\n"
     "    x_hi = __reduce_max_sync(0xffffffffu, x_hi);\n"
     "    y_lo = __reduce_min_sync(0xffffffffu, y_lo);\n"
     "    y_hi = __reduce_max_sync(0xffffffffu, y_hi);\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "      s_box[threadIdx.x / 32] = x_lo;\n"
     "      s_box[kWarps + threadIdx.x / 32] = x_hi;\n"
     "      s_box[2 * kWarps + threadIdx.x / 32] = y_lo;\n"
     "      s_box[3 * kWarps + threadIdx.x / 32] = y_hi;\n"
     "    }\n"
     "    __syncthreads();\n"
     "    for (int w = 0; w < kWarps; ++w) {\n"
     "      x_lo = min(x_lo, s_box[w]);\n"
     "      x_hi = max(x_hi, s_box[kWarps + w]);\n"
     "      y_lo = min(y_lo, s_box[2 * kWarps + w]);\n"
     "      y_hi = max(y_hi, s_box[3 * kWarps + w]);\n"
     "    }\n"
     "    const int bw = x_lo <= x_hi ? min(x_hi - x_lo + 1, kEntries) : 0;\n"
     "    const int bh = bw > 0 ? min(y_hi - y_lo + 1, kEntries / bw) : 0;\n"
     "    for (int i = threadIdx.x; i < (bw * bh * WS + 3) / 4; i += kThreads) {\n"
     "      reinterpret_cast<float4*>(s_win)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
     "    }\n"
     "    __syncthreads();\n"),
    (_SCATTER,
     "          const int ix = ((q & 1) ? sq.y : sq.x) - x_lo, iy = ((q & 2) ? sq.w : sq.z) - y_lo;\n"
     "          if (any && (unsigned)ix < (unsigned)bw && (unsigned)iy < (unsigned)bh) {\n"
     "            const float4 val = times_groups<NE>(r[n], s);\n"
     "            float* cell = s_win + (iy * bw + ix) * WS + j * NV + n;\n"
     "            atomicAdd(cell, val.x);\n"
     "            atomicAdd(cell + C4, val.y);\n"
     "            atomicAdd(cell + 2 * C4, val.z);\n"
     "            atomicAdd(cell + 3 * C4, val.w);\n"
     "          } else " + _SCATTER.lstrip()),
    ("    flush();\n    __syncthreads();\n",
     "    flush();\n    __syncthreads();\n"
     "    for (int i = threadIdx.x; i < bw * bh * C4; i += kThreads) {\n"
     "      const int e = i / C4;\n"
     "      const float* cell = s_win + e * WS + (i - e * C4);\n"
     "      const float4 s = make_float4(cell[0], cell[C4], cell[2 * C4], cell[3 * C4]);\n"
     "      if (s.x != 0.0f || s.y != 0.0f || s.z != 0.0f || s.w != 0.0f) {\n"
     "        const size_t q = (size_t)(y_lo + e / bw) * W + x_lo + e % bw;\n"
     "        red_global4(dsrcv + q * C + (i - e * C4) * 4, s);\n"
     "      }\n"
     "    }\n"),
]
_PER_DEPTH = [("{ return kChunkPixels / tile_pixels(C); }", "{ return 1; }")]

VARIANTS = {
    "as built": [],
    "probe: no dsrc scatter": _NO_SCATTER,
    "probe: dsrc as plain stores": _PLAIN_STORES,
    "no sums over depths": _NO_PENDING,
    "shared-memory window": _WINDOW,
    "shared-memory window per depth": _WINDOW + _PER_DEPTH,
    "shared-memory window without padding": _WINDOW + [("{ return C + C / 4; }",
                                                        "{ return C; }")],
    "shared-memory window, no sums over depths": _WINDOW + _NO_PENDING,
    "C = 8 per-pixel threads": [(_LANES, _LANES.replace("C / 4", "C >= 16 ? C / 4 : 1"))],
    "4 blocks per SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")],
    "5 blocks per SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
    "chunks of 256 pairs": [("constexpr int kChunkPixels = 512;",
                             "constexpr int kChunkPixels = 256;")],
    "per-pixel threads, scalar atomics": _PER_PIXEL + _SCALAR_RED,
    "probe: no dsrc scatter (per-pixel threads)": _PER_PIXEL + _NO_SCATTER,
    "probe: dsrc as plain stores (per-pixel threads)": _PER_PIXEL + _SCALAR_STORES,
    "vector atomics (per-pixel threads)": _PER_PIXEL,
}


def launcher(lib, args, dcorr, stream):
    ref, src, src_p, ref_p, dv = args
    b, v, h, w, c = src.shape
    d = dv.shape[1]
    mat = relative_rows(src_p, ref_p)
    dref, dsrc = torch.zeros_like(ref), torch.zeros_like(src)

    def run():
        return lib.warp_corr_bwd_f32(ref.data_ptr(), src.data_ptr(), mat.data_ptr(),
                                     dv.data_ptr(), dcorr.data_ptr(), dref.data_ptr(),
                                     dsrc.data_ptr(), b, v, d, h, w, c, 8, stream)
    return run, dref, dsrc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k8_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    built = build_all("warp_corr_bwd", VARIANTS)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = []
    for s in K8_STAGES:
        a = inputs(rng, *s, "cuda")
        b, v, h, w, _ = a[1].shape
        dcorr = torch.from_numpy(rng.standard_normal((b, v, 8, s[4], h, w), np.float32)).cuda()
        shapes.append((a, dcorr, warp_corr_bwd_plain(*a, dcorr, 8)))
    runs, errs = {}, {}
    for name, (lib, _) in list(built.items()):
        runs[name], errs[name] = [], 0.0
        for a, dcorr, want in shapes:
            run, dref, dsrc = launcher(lib, a, dcorr, stream)
            rc = run()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed with {rc}")
            for got, ref in zip((dref, dsrc), want):
                errs[name] = max(errs[name],
                                 float((got - ref).abs().max()) / float(ref.abs().max()))
            runs[name].append(run)
        if errs[name] > 1e-5 and not name.startswith("probe"):
            print(f"{name!r} disagrees with the plain version ({errs[name]:.3e}); left out")
            del built[name], runs[name]
    names = list(built)
    times = {name: [[] for _ in shapes] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:  # in turns
            for s, run in enumerate(runs[name]):
                times[name][s].append(time_ms(run, args.reps))
    for name in names:
        lib, report = built[name]
        per = [min(ts) for ts in times[name]]
        print(json.dumps({
            "variant": name, "ptxas (kernel, registers, spill bytes, smem)":
                ptxas_summary(report),
            "blocks_per_sm": {f"C={c},D={d}": lib.warp_corr_bwd_blocks_per_sm(c, d)
                              for _, _, _, c, d in K8_STAGES},
            "max_err_of_scale": errs[name],
            "k8_ms_per_stage": [round(t, 4) for t in per],
            "k8_ms_per_micro_batch": round(sum(per), 4),
            "ms_all_rounds": [[round(t, 4) for t in ts] for ts in times[name]],
            "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
