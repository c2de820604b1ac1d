"""Time K1 `warp_group_corr` and K7 `warp_corr_fwd` against probes and
design alternatives on one GPU.

    python -m mvsformer_torch.k1_variants [--reps 20] [--rounds 3]

Each variant is `csrc/warp_corr.cu` with a few lines substituted, built
with the kernels' own nvcc flags (`mvsformer_torch.kernel_variants`).
Variants of the channel-split design as built (from C = 16 on, C/4 lanes
share a pixel, each with one float4 of the reference; coordinates
computed once per (pixel, depth) into shared memory; C = 8 one thread per
pixel):

- "coords per lane": every lane computes its pixel's coordinates and
  weights itself, with no shared-memory broadcast.
- "C = 8 channel-split" and "C = 16 per-pixel threads": the channel split
  from C = 8 on, or only from C = 32 on.
- "5 blocks per SM", "6 blocks per SM": `__launch_bounds__` asks ptxas
  for registers enough for that many 256-thread blocks (4 as built).
- "probe: one pixel": every tap reads source pixel 0 or 1 (by the parity
  of the depth), so each warp-wide load reads one address: perfect
  locality.

Variants of the one-thread-per-pixel design at every C ("per-pixel
threads", the kernel's C = 8 body, which was its only mapping before the
channel split: each thread loops over the depths with the pixel's whole
reference vector in registers and reads each tap's C-vector as C/4
16-byte loads, so lane i of a warp reads 16 bytes C*4 bytes from lane
i-1's):

- "probe: one pixel (per-pixel threads)": as above.
- "probe: coalesced lanes (per-pixel threads)": the same loads,
  instructions and arithmetic, but at addresses that make each warp-wide
  load read 512 contiguous bytes (4 cache lines), as lanes that split a
  tap's C-vector would.

The probes compute wrong numbers on purpose; every other variant is held
to `warp_group_corr_plain` (corr within 1e-4 of its scale, entropy within
1e-3). All are timed by CUDA events, the kernel alone (the relative
projection computed once outside), at the four K1 launch shapes of the
DTU eval request (B=1, 4 source views, 144x192 with C=64, D=32 up to
1152x1536 with C=8, D=4) and the four K7 launch shapes of a training
micro-batch (B=4, 4 source views, 64x80 up to 512x640), in turns over
several rounds, with the synthetic cameras of `chip_smoke.py` and depths
spread over 425-900 at every pixel. Prints the card, then for each
variant its ptxas registers, spills and static shared memory, resident
blocks per SM, and its ms per stage (the least of the rounds), one JSON
line each.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops.warp_corr import relative_rows, warp_group_corr_plain

K1_STAGES = ((1, 144, 192, 64, 32), (1, 288, 384, 32, 16), (1, 576, 768, 16, 8),
             (1, 1152, 1536, 8, 4))  # B, H, W, C, D of the DTU eval request
K7_STAGES = ((4, 64, 80, 64, 32), (4, 128, 160, 32, 16), (4, 256, 320, 16, 8),
             (4, 512, 640, 8, 4))  # a micro-batch of the DTU training step
N_SRC = 4
TAPS = "xyzw"  # the four bilinear taps of Taps.o

_SPLIT_FROM = "constexpr int kSplitFromC = 16;"
_PER_PIXEL = [(_SPLIT_FROM, "constexpr int kSplitFromC = 128;")]
_COORDS_FILL = """\
    for (int i = threadIdx.x; i < nd * TP; i += kThreads) {
      const int tt = i % TP;
      const int pp = min(p0 + tt, HW - 1);
      const Taps tp = taps_at(M, ray(M, pp, W), dvb[(size_t)(d0 + i / TP) * HW + pp], W, H);
      s_w[i] = tp.w;
      s_o[i] = tp.o;
    }
    __syncthreads();
"""
_COORDS_PER_LANE = [
    (_COORDS_FILL, ""),
    ("const Taps tp = {s_w[dd * TP + t], s_o[dd * TP + t]};",
     "const Taps tp = taps_at(M, ray(M, p, W), dvb[(size_t)(d0 + dd) * HW + p], W, H);"),
]
# Every tap at source pixel 0 or 1: the channel-split body, then the per-pixel one.
_ONE_PIXEL = [(f"__ldg(src4 + (size_t)tp.o.{x} * L + j)",
               "__ldg(src4 + (size_t)((d0 + dd) & 1) * L + j)") for x in TAPS] + \
             [(f"src4 + (size_t)tp.o.{x} * (C / 4);", "src4 + (size_t)(d & 1) * (C / 4);")
              for x in TAPS]
_TAP_PTRS = ("t00", "t01", "t10", "t11")
_COALESCED = [(f"{t} = src4 + (size_t)tp.o.{x} * (C / 4);",
               f"{t} = src4 + (size_t)min(tp.o.{x} & ~31, HW - 32) * (C / 4) + (threadIdx.x & 31);")
              for t, x in zip(_TAP_PTRS, TAPS)] + \
             [(f"__ldg({t} + i)", f"__ldg({t} + i * 32)") for t in _TAP_PTRS]

VARIANTS = {
    "as built": [],
    "coords per lane": _COORDS_PER_LANE,
    "C = 8 channel-split": [(_SPLIT_FROM, "constexpr int kSplitFromC = 8;")],
    "C = 16 per-pixel threads": [(_SPLIT_FROM, "constexpr int kSplitFromC = 32;")],
    "5 blocks per SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
    "6 blocks per SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 6)")],
    "probe: one pixel": _ONE_PIXEL,
    "per-pixel threads": _PER_PIXEL,
    "probe: one pixel (per-pixel threads)": _PER_PIXEL + _ONE_PIXEL,
    "probe: coalesced lanes (per-pixel threads)": _PER_PIXEL + _COALESCED,
}


def inputs(rng, b, h, w, c, d, dev):
    """ref, src, mat [B,V,3,4], dv for one launch: chip_smoke's cameras (views
    2 m apart along x, focal 1.2 W) and depths spread over 425-900."""
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]], np.float32)
    projs = []
    for v in range(N_SRC + 1):
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = K
        P[0, 3] = K[0, 0] * v * 2.0
        projs.append(P)
    projs = np.broadcast_to(np.stack(projs)[None], (b, N_SRC + 1, 4, 4)).copy()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    ref_p, src_p = t(projs[:, 0]), t(projs[:, 1:])
    dv = np.broadcast_to(np.linspace(425, 900, d, dtype=np.float32)[None, :, None, None],
                         (b, d, h, w))
    return (t(rng.standard_normal((b, h, w, c))), t(rng.standard_normal((b, N_SRC, h, w, c))),
            src_p, ref_p, t(dv))


def launcher(lib, kernel, args, stream):
    ref, src, src_p, ref_p, dv = args
    b, v, h, w, c = src.shape
    d = dv.shape[1]
    mat = relative_rows(src_p, ref_p)
    corr = torch.empty((b, v, 8, d, h, w), device=src.device)
    ent = torch.empty((b, v, h, w), device=src.device)
    if kernel == "K1":
        def run():
            return lib.warp_group_corr_f32(ref.data_ptr(), src.data_ptr(), mat.data_ptr(),
                                           dv.data_ptr(), corr.data_ptr(), ent.data_ptr(),
                                           b, v, d, h, w, c, 8, stream)
    else:
        def run():
            return lib.warp_corr_fwd_f32(ref.data_ptr(), src.data_ptr(), mat.data_ptr(),
                                         dv.data_ptr(), corr.data_ptr(), b, v, d, h, w, c,
                                         8, stream)
    return run, corr, ent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    built = build_all("warp_corr", VARIANTS)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [("K1", s, inputs(rng, *s, "cuda")) for s in K1_STAGES] + \
             [("K7", s, inputs(rng, *s, "cuda")) for s in K7_STAGES]
    runs, errs = {}, {}
    for name, (lib, _) in list(built.items()):
        runs[name], errs[name] = [], 0.0
        for kernel, _, a in shapes:
            run, corr, ent = launcher(lib, kernel, a, stream)
            rc = run()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed with {rc}")
            if kernel == "K1":
                want_c, want_e = warp_group_corr_plain(*a, groups=8)
                scale = max(1.0, float(want_c.abs().max()))
                e = float((corr - want_c).abs().max()) / scale
                e_ent = float((ent - want_e).abs().max())
                errs[name] = max(errs[name], e, e_ent * 0.1)  # bounds 1e-4 and 1e-3
            runs[name].append(run)
        if errs[name] > 1e-4 and not name.startswith("probe"):
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
        blocks = {f"C={c},D={d}": lib.warp_corr_blocks_per_sm(c, d, 1)
                  for _, _, _, c, d in K1_STAGES}
        print(json.dumps({
            "variant": name, "ptxas (kernel, registers, spill bytes, smem)":
                ptxas_summary(report),
            "blocks_per_sm": blocks, "max_err_of_scale": errs[name],
            "k1_ms_per_stage": [round(t, 4) for t in per[:4]],
            "k1_ms_per_request": round(sum(per[:4]), 4),
            "k7_ms_per_stage": [round(t, 4) for t in per[4:]],
            "k7_ms_per_micro_batch": round(sum(per[4:]), 4),
            "ms_all_rounds": [[round(t, 4) for t in ts] for ts in times[name]],
            "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
