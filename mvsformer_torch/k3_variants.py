"""Time K3 `depth_decode` against probes and design alternatives on one GPU.

    python -m mvsformer_torch.k3_variants [--reps 20] [--rounds 3] [--parent DIR]

Shapes: the DTU eval request's 4 launches, B = 1 and (D, H, W) = (32, 144,
192), (16, 288, 384), (8, 576, 768), (4, 1152, 1536) at temperatures 5, 5,
5, 1; logits standard normal x 3 from seed 0, depths sorted uniform in
[425, 900] per pixel. Inputs are not flushed from the 50 MB L2 between
launches: stages 1-3 (7-28 MB of inputs) stay in it, stage 4 (57 MB) does
not.

Each variant is `csrc/depth_decode.cu` with a few lines substituted, built
with the kernels' own nvcc flags (`mvsformer_torch.kernel_variants`), held
to `depth_decode_plain` within K3's tolerances (depth 1e-3 + 1e-5 |d|,
conf 1e-6 + 1e-5 |c|; probes compute wrong numbers on purpose and are not
held), and timed alone (its C function called directly, no wrapper) in two
ways, the least of the rounds, variants in turns:
  events: CUDA events over `--reps` back-to-back launches (what
          `chip_smoke.py` records), which read the host's time per launch
          when it exceeds the device's;
  graph:  the same launch captured 20 times in one CUDA graph and replayed,
          the device's time alone.
Variants of the design as built (`VARIANTS`; one thread per pixel or per 4
pixels with 16-byte loads up to 8 depths, a pass of up to 32 depths in
registers, 128 threads a block): a pixel's depths over 2 or 4 lanes merged
by shuffles, no 16-byte loads, 16-byte loads up to 16 depths (two passes),
passes of at most 8 depths (merged partials), 256 threads a block, 8
blocks an SM (at most 64 registers), streaming loads, exponentials by
ex2.approx; and the probes no exponential and no depth read (the logits
read twice instead).

Then the four probes of the wrapper's kernel (`ops/stage_tail.py`), per
shape: (a) the kernel alone by events, (b) by graph, (c) host microseconds
per launch (`time.perf_counter` over 1,000 launches, no synchronize), (d)
ms through the wrapper `stage_tail.depth_decode` by events, and its host
microseconds per call; then the host microseconds of each step of this
tree's wrapper taken alone, at stage 1. With `--parent DIR` (a checkout of an earlier tree,
e.g. `git archive 9675fdb | tar -x -C scratch_chip/p10`) the same probes
of that tree's `ops/stage_tail.py`, imported from DIR; its Triton kernel
alone is its `_triton_kernel()` launched on its grid.

With `--rounds 0` it builds and checks every variant and times nothing.
Prints the card, then one JSON line per variant and per set of probes, with
ms per launch shape, per request (the 4 shapes) and the share of the
request's 0.037 ms bytes bound (inputs read once, outputs written once,
over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from mvsformer_torch.kernel_variants import build_all, card, ptxas_summary, time_ms
from mvsformer_torch.ops import cuda_build, stage_tail

B = 1
# (D, H, W, temperature) of the request's 4 launches.
SHAPES = ((32, 144, 192, 5.0), (16, 288, 384, 5.0), (8, 576, 768, 5.0), (4, 1152, 1536, 1.0))
HBM_BYTES_PER_S = 3.35e12
GRAPH_LAUNCHES = 20
HOST_LAUNCHES = 1000
DEPTH_ATOL, DEPTH_RTOL = 1e-3, 1e-5  # chip_smoke.py's K3 tolerances
CONF_ATOL, CONF_RTOL = 1e-6, 1e-5


def bytes_bound_ms(d, h, w):
    return 4 * (2 * B * d * h * w + 2 * B * h * w) / HBM_BYTES_PER_S * 1e3


_EXP = "          const float et = expf(tmp * x);\n          part[v].s1 += expf(x);\n"
_DV_LOAD = "      load<VEC>(w[j], dp + plane);\n"
VARIANTS = {
    "as built": [],
    "2 lanes a pixel": [("constexpr int kLanes = 1;", "constexpr int kLanes = 2;")],
    "4 lanes a pixel": [("constexpr int kLanes = 1;", "constexpr int kLanes = 4;")],
    "no 16-byte loads": [("  const bool vec = HW % 4 == 0", "  const bool vec = false && HW % 4 == 0")],
    "16-byte loads up to 16 depths (two passes)": [
        ("constexpr int kVecDepths = 8;", "constexpr int kVecDepths = 16;")],
    "passes of at most 8 depths": [("constexpr int kRegs = 32;", "constexpr int kRegs = 8;")],
    "256 threads a block": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "8 blocks an SM (64 registers)": [("__global__ void __launch_bounds__(kThreads) depth",
                                       "__global__ void __launch_bounds__(kThreads, 8) depth")],
    "streaming loads": [("__ldg(reinterpret_cast<const float4*>(p))",
                         "__ldcs(reinterpret_cast<const float4*>(p))"),
                        ("    x[0] = __ldg(p);", "    x[0] = __ldcs(p);")],
    "ex2.approx exponentials": [(_EXP, _EXP.replace("expf(", "__expf("))],
    "probe: no exponential": [(_EXP, "          const float et = tmp * x;\n"
                                     "          part[v].s1 += x;\n")],
    "probe: no depth read": [(_DV_LOAD, "      load<VEC>(w[j], lp + plane);\n")],
}


def make_cases(seed=0):
    """[(label, logits, dv, tmp, depth out, conf out)] on the card."""
    rng = np.random.default_rng(seed)
    cases = []
    for d, h, w, tmp in SHAPES:
        logits = (rng.standard_normal((B, d, h, w)) * 3).astype(np.float32)
        dv = np.sort(rng.uniform(425, 900, (B, d, h, w)).astype(np.float32), axis=1)
        logits, dv = torch.from_numpy(logits).cuda(), torch.from_numpy(dv).cuda()
        out = torch.empty((B, h, w), dtype=torch.float32, device="cuda")
        cases.append((f"D={d} {h}x{w}", logits, dv, tmp, out, torch.empty_like(out)))
    return cases


def cuda_launch(lib):
    """launch(case, stream): one launch of a built library's depth_decode_f32."""
    def launch(case, stream):
        _, logits, dv, tmp, depth, conf = case
        b, d, h, w = logits.shape
        rc = lib.depth_decode_f32(logits.data_ptr(), dv.data_ptr(), depth.data_ptr(),
                                  conf.data_ptr(), b, d, h * w, tmp, stream)
        cuda_build.check_launch(rc, "depth_decode")
    return launch


def triton_launch(module):
    """launch(case, stream): one launch of an earlier tree's Triton kernel,
    on its grid, on torch's current stream (Triton's own choice)."""
    kernel = module._triton_kernel()

    def launch(case, stream):
        _, logits, dv, tmp, depth, conf = case
        b, d, h, w = logits.shape
        kernel[(-(-(h * w) // module.BLOCK), b)](logits, dv, depth, conf, h * w, tmp,
                                                  D=d, BLOCK=module.BLOCK, num_warps=4)
    return launch


def parent_stage_tail(tree: Path):
    """`mvsformer_torch/ops/stage_tail.py` of the tree at `tree`, imported
    as a module of its own (its imports resolve to this tree's package)."""
    spec = importlib.util.spec_from_file_location(
        "parent_stage_tail", tree / "mvsformer_torch" / "ops" / "stage_tail.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check(case):
    """(within K3's tolerances, max |depth error|, max |conf error|) of the
    outputs of `case` against the plain version."""
    _, logits, dv, tmp, depth, conf = case
    want_d, want_c = stage_tail.depth_decode_plain(logits, dv, tmp)
    ok = bool(((depth - want_d).abs() <= DEPTH_ATOL + DEPTH_RTOL * want_d.abs()).all()
              and ((conf - want_c).abs() <= CONF_ATOL + CONF_RTOL * want_c.abs()).all())
    return ok, float((depth - want_d).abs().max()), float((conf - want_c).abs().max())


def graph_ms(launch, case, reps):
    """Device ms per launch: GRAPH_LAUNCHES launches captured in one CUDA
    graph, replayed `reps` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(case, side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(GRAPH_LAUNCHES):
            launch(case, stream)
    return time_ms(graph.replay, reps) / GRAPH_LAUNCHES


def host_us(fn):
    """Host microseconds per call of `fn` over HOST_LAUNCHES calls, no
    synchronize inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_LAUNCHES):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / HOST_LAUNCHES * 1e6


def probes(launch, wrapper, cases, reps):
    """{label: {probe: value}} of the four probes, and the wrapper's host
    microseconds per call."""
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case in cases:
        label, logits, dv, tmp = case[:4]
        out[label] = {
            "a_events_ms": time_ms(lambda: launch(case, stream), reps),
            "b_graph_ms": graph_ms(launch, case, reps),
            "c_host_us": host_us(lambda: launch(case, stream)),
            "d_wrapper_ms": time_ms(lambda: wrapper(logits, dv, tmp), reps),
            "wrapper_host_us": host_us(lambda: wrapper(logits, dv, tmp)),
        }
    return out


def wrapper_steps_us(case):
    """Host microseconds per call of each step of this tree's wrapper taken
    alone, to show where its time goes."""
    _, logits, dv, tmp, depth, conf = case
    dev = logits.device
    b, d, h, w = logits.shape
    lib = cuda_build.library("depth_decode")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "require_cuda_inputs": lambda: cuda_build.require_cuda_inputs("k3", logits, dv),
        "check_f32_contiguous": lambda: cuda_build.check_f32_contiguous(
            "k3", logits=logits, depth_values=dv),
        "two torch.empty": lambda: (torch.empty((b, h, w), dtype=torch.float32, device=dev),
                                    torch.empty((b, h, w), dtype=torch.float32, device=dev)),
        "torch.cuda.device context": device_context,
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes launch": lambda: lib.depth_decode_f32(
            logits.data_ptr(), dv.data_ptr(), depth.data_ptr(), conf.data_ptr(), b, d, h * w,
            tmp, stream),
        "eval_outputs": lambda: cuda_build.eval_outputs("k3", (depth, conf), logits, dv),
        "the wrapper": lambda: stage_tail.depth_decode(logits, dv, tmp),
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def summary(ms_by_label, bound):
    per_request = sum(ms_by_label.values())
    return {"ms": {k: round(v, 5) for k, v in ms_by_label.items()},
            "ms_per_request": round(per_request, 5),
            "share_of_bytes_bound": round(bound / per_request, 4)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier tree, to probe its K3 in the same call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: no CUDA device")
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    built = build_all("depth_decode", VARIANTS)
    cases = make_cases()
    bound = sum(bytes_bound_ms(d, h, w) for d, h, w, _ in SHAPES)
    stream = torch.cuda.current_stream().cuda_stream
    errs = {}
    for name, (lib, _) in list(built.items()):
        launch = cuda_launch(lib)
        found = []
        for case in cases:
            launch(case, stream)
            found.append(check(case))
        errs[name] = {"within_tolerance": all(f[0] for f in found),
                      "max_abs_err_depth": max(f[1] for f in found),
                      "max_abs_err_conf": max(f[2] for f in found)}
        if not errs[name]["within_tolerance"] and "probe" not in name:
            print(f"{name!r} disagrees with the plain version ({errs[name]}); left out",
                  flush=True)
            del built[name]
    names = list(built)
    times = {name: {how: {case[0]: [] for case in cases} for how in ("events", "graph")}
             for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:  # in turns
            launch = cuda_launch(built[name][0])
            for case in cases:
                times[name]["events"][case[0]].append(
                    time_ms(lambda: launch(case, stream), args.reps))
                times[name]["graph"][case[0]].append(graph_ms(launch, case, args.reps))
    for name in names:
        line = {"variant": name, "ptxas": ptxas_summary(built[name][1]), **errs[name]}
        if args.rounds:
            for how, by_label in times[name].items():
                line[how] = summary({k: min(v) for k, v in by_label.items()}, bound)
        print(json.dumps({**line, "card": name_limit}), flush=True)
    if not args.rounds:
        return 0
    trees = {"this tree": (cuda_launch(cuda_build.library("depth_decode")), stage_tail)}
    if args.parent is not None:
        parent = parent_stage_tail(args.parent)
        trees["parent"] = (triton_launch(parent), parent)
    probed = {tree: [] for tree in trees}
    order = list(trees)
    for r in range(args.rounds):  # trees in turns; the least of the rounds
        for tree in order[r % len(order):] + order[:r % len(order)]:
            launch, module = trees[tree]
            probed[tree].append(probes(launch, module.depth_decode, cases, args.reps))
    for tree, rounds in probed.items():
        least = {label: {key: min(p[label][key] for p in rounds) for key in rounds[0][label]}
                 for label in rounds[0]}
        per_request = {key: sum(v[key] for v in least.values())
                       for key in next(iter(least.values()))}
        print(json.dumps({"probes": tree, "by_shape": least, "per_request": per_request,
                          "bytes_bound_ms": bound, "card": name_limit}), flush=True)
    print(json.dumps({"wrapper_steps_host_us": wrapper_steps_us(cases[0]), "shape": cases[0][0],
                      "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
