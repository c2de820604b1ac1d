#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Print the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel from `mvsformer_torch/csrc/` (one nvcc per
   source, all at once) and print the build time.
3. Build TwinMVSNet on `cuda` in fp32 at the default ModelConfig (the full
   width of alt_gvt_small, ndepths 32/16/8/4, inverse depth, cnn fusion, ce
   decode), with weights and non-trivial BN running stats drawn from a
   seeded torch.Generator. The FPN encoder head is K4 and each top-down
   FPN level K5 (the JAX package's default flags), and each global
   sub-sampled attention of the backbone is K6. Its forward runs with TF32
   off (checked in 4), so the request that is timed is the one phase 7
   checks.
4. Serve a synthetic DTU-eval request (B=1, 5 views, 1152x1536, 192 depths;
   the cameras of `__graft_entry__._synthetic_batch`) through
   `make_infer_fn`: one warm-up request, then 3 timed requests, each with
   every launch count set to 0 just before it and read just after it (and
   the peak memory counted over the three alone). Per request, K1-K3 must
   launch once per stage (4), K4 once, K5 once per FPN level (3) and K6
   once per global sub-sampled attention block of the backbone (9). One
   more request records the tensors the forward feeds each kernel.
5. Check the outputs: finite, depth within [depth_min, depth_max] and every
   stage's depth within its hypotheses, confidence in (0, 1].
   A further request is timed layer by layer (CUDA events on forward hooks)
   and one under torch.profiler for the device's idle share.
6. With TF32 off, hold every kernel against its plain PyTorch version on
   the card, on the tensors the forward fed it at every call of the
   recorded request (K1-K3 at each of the 4 stages, and K1 once more at
   V=1, the one-view form; K4 once; K5 at each FPN level; K6 at each GSA
   block), and time both; for K6 also time scaled_dot_product_attention on
   the same inputs as the library yardstick.
7. Run the __graft_entry__ request (B=1, 3 views, 128x128, 192 depths) on
   the card and, with the same weights, on the CPU (the plain versions),
   TF32 off, and compare depth and confidences.
8. Print one JSON line of per-kernel numbers, then, last, the result line
   {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over 67 TFLOP/s (fp32 outside
the tensor cores), the published H100 SXM peaks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
N_REQUESTS = 3
B, V, H, W, NDEPTH_FULL = 1, 5, 1152, 1536, 192
DEPTH_MIN, DEPTH_MAX = 425.0, 900.0

# Tolerances for kernel vs plain version (both fp32 on the card, TF32 off).
# K1: the two compute the same products in another order (FMA contraction,
#     per-group sums); pixel coordinates ~1e3 differ in their last bit, and
#     bilinear sampling with zero padding is continuous in them, so the
#     error is a few ulps of the correlation's scale.
K1_RTOL_OF_SCALE = 1e-4   # |corr error| <= 1e-4 * max|corr|
K1_ENT_ATOL = 1e-3        # entropy in nats, <= log(32) ~ 3.47
# K2: ~3.6k multiply-adds per pixel summed in another order than cuDNN's.
K2_ATOL = 1e-5            # weights lie in (0, 1)
# K3: exp(tmp*(l-m)) against softmax(tmp*l): weights differ by ~1e-6
#     relative; the depth is a weighted mean of depths ~500 apart.
K3_DEPTH_ATOL, K3_DEPTH_RTOL = 1e-3, 1e-5
K3_CONF_ATOL, K3_CONF_RTOL = 1e-6, 1e-5
# K4, K5: fp32 convolutions against cuDNN's, which may pick a Winograd or
#     FFT algorithm with a larger fp32 error than direct sums. K4 sums
#     147-200 products per output through three layers; K5 64 x 9 + cl,
#     after an interpolation whose align-corners weights are computed as
#     PyTorch computes them (a wrong weight shows at 1e-2 of the scale).
K4_RTOL_OF_SCALE = 1e-4   # per output (conv01, down0), of max(1, its max |value|)
K5_RTOL_OF_SCALE = 1e-4   # per output (out, intra'), of max(1, its max |value|)
# K6: fp32 logits and probabilities on both sides; the kernel's online
#     softmax rescales its sums per 32 keys, the plain version divides once.
K6_RTOL_OF_SCALE = 1e-5   # of max(1, max |output|): a convex mix of v rows
# End to end, the forward on the card (kernels, cuDNN, cuBLAS) against the
# same weights on the CPU (plain versions) at the __graft_entry__ request,
# TF32 off: the bounds tests/test_torch_model.py holds the port to against
# the JAX model (sums in another order, through four stages of decode).
E2E_SHAPE = (1, 3, 128, 128)  # B, V, H, W
E2E_DEPTH_ATOL = 1e-2         # depth units over the 425-900 range
E2E_CONF_ATOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_request(torch, b=B, v_=V, h=H, w=W, device="cuda"):
    """__graft_entry__._synthetic_batch (DTU eval shape by default), as tensors."""
    import numpy as np

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((b, v_, h, w, 3)).astype(np.float32)
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]], np.float32)
    projs = {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = np.zeros((b, v_, 2, 4, 4), np.float32)
        for v in range(v_):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * 2.0
            cams[:, v, 0] = ext
            cams[:, v, 1, :3, :3] = K * scale
            cams[:, v, 1, 2, 2] = 1.0
            cams[:, v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = torch.from_numpy(cams).to(device)
    dv = np.broadcast_to(np.linspace(DEPTH_MIN, DEPTH_MAX, NDEPTH_FULL,
                                     dtype=np.float32)[None], (b, NDEPTH_FULL)).copy()
    return torch.from_numpy(imgs).to(device), projs, torch.from_numpy(dv).to(device)


def time_ms(torch, fn, reps=10):
    """Mean device time of fn() over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def k1_cost(args, kwargs):
    ref, src, _, _, dv = args[:5]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    nbytes = 4 * (b * hw * c + b * v * hw * c + b * d * hw + b * v * 16 + b * 16
                  + b * v * g * d * hw + b * v * hw)
    # per (view, depth, pixel): ~30 coordinate/weight ops, 4 taps x C FMAs,
    # C FMAs for the products, G means, ~10 for the entropy.
    flops = b * v * d * hw * (30 + 8 * c + 2 * c + g + 10)
    return nbytes, flops


def k2_cost(args, kwargs):
    ent = args[0]
    n, h, w = ent.shape
    nbytes = 4 * (2 * n * h * w + 3689)
    flops = n * h * w * (2 * (9 * 16 + 144 * 16 + 144 * 8 + 8) + 3 * 40 + 4)
    return nbytes, flops


def k3_cost(args, kwargs):
    logits = args[0]
    b, d, h, w = logits.shape
    return 4 * (2 * b * d * h * w + 2 * b * h * w), b * h * w * d * 10


def k4_cost(args, kwargs):
    n, _, h, w = args[0].shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    nbytes = 4 * (n * 3 * h * w + n * 8 * h * w + n * 16 * ho * wo + 6040)
    # multiply-adds of the three convs, then BN (2) and lrelu (1) per output.
    macs = n * h * w * (7 * 7 * 3 * 8 + 5 * 5 * 8 * 8) + n * ho * wo * 5 * 5 * 8 * 16
    return nbytes, 2 * macs + 3 * (2 * n * 8 * h * w + n * 16 * ho * wo)


def k5_cost(args, kwargs):
    prev, lat, _, _, k3 = args[:5]
    n, _, h, w = prev.shape
    cl, co, hw = lat.shape[1], k3.shape[0], 4 * h * w
    emit = kwargs.get("emit_intra", False)
    nbytes = 4 * (prev.numel() + lat.numel() + n * co * hw + (n * 64 * hw if emit else 0)
                  + 64 * (cl + 1) + co * (576 + 3))
    # per pixel: 1x1 and 3x3 multiply-adds, ~10 ops per channel for the
    # align-corners lerp and the bias, ~8 per output for bias, BN and swish.
    return nbytes, n * hw * (2 * 64 * (cl + 9 * co) + 64 * 10 + co * 8)


def k6_cost(args, kwargs):
    q, k, _, nh = args
    b, n, c = q.shape
    nk = k.shape[1]
    # the two products, and ~5 ops per logit for the scale and online softmax.
    return 4 * (2 * b * n * c + 2 * b * nk * c), 4 * b * n * nk * c + 5 * b * nh * n * nk


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def layer_breakdown(torch, model, fn, request):
    """Device time per layer in one request, from CUDA events recorded by
    forward hooks around the model's top-level layers and each stage's
    visibility CNN (K2) and cost regulariser; a stage's remainder is K1, the
    weighted view sum and K3."""
    nst = len(model.fusions)
    names = ["encoder", "vit", "decoder_vit", "decoder"]
    for i in range(nst):
        names += [f"fusions.{i}", f"fusions.{i}.vis", f"fusions.{i}.cost_reg"]
    modules = dict(model.named_modules())
    spans, hooks = {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for name in names:
        def pre(mod, args, name=name):
            spans.setdefault(name, []).append([event(), None])

        def post(mod, args, out, name=name):
            spans[name][-1][1] = event()
        hooks += [modules[name].register_forward_pre_hook(pre),
                  modules[name].register_forward_hook(post)]
    try:
        torch.cuda.synchronize()
        start = event()
        fn(*request)
        end = event()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    ms = {n: sum(a.elapsed_time(b) for a, b in spans[n]) for n in names}
    out = {n: ms[n] for n in ("encoder", "vit", "decoder_vit", "decoder")}
    for i in range(nst):
        out[f"stage{i + 1}.vis(K2)"] = ms[f"fusions.{i}.vis"]
        out[f"stage{i + 1}.cost_reg"] = ms[f"fusions.{i}.cost_reg"]
        out[f"stage{i + 1}.warp+sum+decode"] = (ms[f"fusions.{i}"] - ms[f"fusions.{i}.vis"]
                                                - ms[f"fusions.{i}.cost_reg"])
    total = start.elapsed_time(end)
    out["other (resizes, hypotheses, confidence)"] = total - sum(
        ms[n] for n in ("encoder", "vit", "decoder_vit", "decoder")) - sum(
        ms[f"fusions.{i}"] for i in range(nst))
    out["total"] = total
    return out


def device_busy(torch, fn, request):
    """(device kernel ms, wall ms, top kernels) of one request under
    torch.profiler; kernel ms is None when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    if not by_name:
        return None, wall_ms, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return sum(by_name.values()), wall_ms, top


def small_request_errors(torch, model, make_infer_fn):
    """Max |card - CPU| of refined depth, combined confidence and each stage's
    confidence for one E2E_SHAPE request through make_infer_fn."""
    import copy

    cpu_model = copy.deepcopy(model).cpu()
    got = make_infer_fn(model)(*synthetic_request(torch, *E2E_SHAPE))
    want = make_infer_fn(cpu_model)(*synthetic_request(torch, *E2E_SHAPE, device="cpu"))
    errs = {"refined_depth": max_err(got[0].cpu(), want[0]),
            "photometric_confidence": max_err(got[1].cpu(), want[1])}
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        errs[f"stage{i + 1}_confidence"] = max_err(g.cpu(), w)
    if not all(torch.isfinite(t).all() for t in (got[0], got[1])):
        raise RuntimeError("small request: non-finite output on the card")
    return errs


def rel_compare(rtol_of_scale, names):
    """Compare outputs one by one: |got - want| <= rtol * max(1, max|want|)."""
    def compare(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok, err, parts = True, 0.0, []
        for name, g, w in zip(names, got, want):
            e, allowed = max_err(g, w), rtol_of_scale * max(1.0, float(w.abs().max()))
            ok, err = ok and e <= allowed, max(err, e)
            parts.append(f"{name} {e:.3e} (<= {allowed:.3e})")
        return ok, err, ", ".join(parts), f"{rtol_of_scale:g} of max(1, max |output|)"
    return compare


def compare_k1(got, want):
    scale = max(1.0, float(want[0].abs().max()))
    e_corr, e_ent = max_err(got[0], want[0]), max_err(got[1], want[1])
    return (e_corr <= K1_RTOL_OF_SCALE * scale and e_ent <= K1_ENT_ATOL, max(e_corr, e_ent),
            f"corr {e_corr:.3e}, entropy {e_ent:.3e}",
            f"corr <= {K1_RTOL_OF_SCALE:g}*{scale:.3f}, entropy <= {K1_ENT_ATOL:g}")


def compare_k2(got, want):
    err = max_err(got, want)
    return err <= K2_ATOL, err, f"{err:.3e}", f"{K2_ATOL:g}"


def compare_k3(got, want):
    e_d = float(((got[0] - want[0]).abs() - K3_DEPTH_RTOL * want[0].abs()).max())
    e_c = float(((got[1] - want[1]).abs() - K3_CONF_RTOL * want[1].abs()).max())
    err_d, err_c = max_err(got[0], want[0]), max_err(got[1], want[1])
    return (e_d <= K3_DEPTH_ATOL and e_c <= K3_CONF_ATOL, max(err_d, err_c),
            f"depth {err_d:.3e}, conf {err_c:.3e}",
            f"depth {K3_DEPTH_ATOL:g}+{K3_DEPTH_RTOL:g}|d|, conf {K3_CONF_ATOL:g}+{K3_CONF_RTOL:g}|c|")


def sdpa(torch, args):
    """K6's library yardstick: one scaled_dot_product_attention call on the
    same q, k, v (heads split as views), and the map of its [B, heads, N,
    hd] output back to K6's [B, N, C]."""
    import torch.nn.functional as F

    q, k, v, nh = args
    b, n, c = q.shape
    qh, kh, vh = (t.reshape(b, t.shape[1], nh, c // nh).transpose(1, 2) for t in (q, k, v))
    return (lambda: F.scaled_dot_product_attention(qh, kh, vh),
            lambda out: out.transpose(1, 2).reshape(b, n, c))


def call_label(name, i, args):
    if name == "encoder_head":
        return "request"
    if name == "fpn_level":
        return f"level{i + 1}"
    if name == "gsa_attention":
        return f"block{i + 1} N={args[0].shape[1]} C={args[0].shape[2]}"
    return f"stage{i + 1}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models import fpn, stagenet, twins
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import (cuda_build, encoder_head, fpn_level, gsa_attention,
                                     stage_tail, vis_net, warp_corr)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. Build the kernels.
    t0 = time.perf_counter()
    report = cuda_build.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({', '.join(report)})")
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. The model.
    t0 = time.perf_counter()
    cfg = ModelConfig()
    model = build_model(cfg, device="cuda")
    random_init_(model, torch.Generator().manual_seed(0))
    print(f"model: TwinMVSNet alt_gvt_small fp32, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")
    imgs, projs, dv = synthetic_request(torch)
    fn = make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0))
    nstages = len(cfg.ndepths)

    # Every kernel of the path: its wrapper and plain version, the module
    # whose global the model calls it through, and its launches per request.
    specs = {
        "warp_group_corr": dict(
            kernel=warp_corr.warp_group_corr, plain=warp_corr.warp_group_corr_plain,
            owner=stagenet, per_request=nstages, cost=k1_cost, compare=compare_k1,
            route="cuda", source="mvsformer_torch/csrc/warp_corr.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr.py:1325"),
        "visibility_net": dict(
            kernel=vis_net.visibility_net, plain=vis_net.visibility_net_plain,
            owner=stagenet, per_request=nstages, cost=k2_cost, compare=compare_k2,
            route="cuda", source="mvsformer_torch/csrc/vis_net.cu",
            replaces="mvsformer_tpu/ops/pallas/vis_net.py:192"),
        "depth_decode": dict(
            kernel=stage_tail.depth_decode, plain=stage_tail.depth_decode_plain,
            owner=stagenet, per_request=nstages, cost=k3_cost, compare=compare_k3,
            route="triton", source="mvsformer_torch/ops/stage_tail.py",
            replaces="mvsformer_tpu/ops/pallas/stage_tail.py:57"),
        "encoder_head": dict(
            kernel=encoder_head.encoder_head, plain=encoder_head.encoder_head_plain,
            owner=fpn, per_request=1, cost=k4_cost,
            compare=rel_compare(K4_RTOL_OF_SCALE, ("conv01", "down0")),
            route="cuda", source="mvsformer_torch/csrc/encoder_head.cu",
            replaces="mvsformer_tpu/ops/pallas/encoder_head.py:213"),
        "fpn_level": dict(
            kernel=fpn_level.fpn_level, plain=fpn_level.fpn_level_plain,
            owner=fpn, per_request=3, cost=k5_cost,
            compare=rel_compare(K5_RTOL_OF_SCALE, ("out", "intra'")),
            route="cuda", source="mvsformer_torch/csrc/fpn_level.cu",
            replaces="mvsformer_tpu/ops/pallas/fpn_final.py:212"),
        "gsa_attention": dict(
            kernel=gsa_attention.gsa_attention, plain=gsa_attention.gsa_attention_plain,
            owner=twins, per_request=sum(d // 2 for d in model.vit.depths), cost=k6_cost,
            compare=rel_compare(K6_RTOL_OF_SCALE, ("out",)), library=sdpa,
            route="cuda", source="mvsformer_torch/csrc/gsa_attention.cu",
            replaces="mvsformer_tpu/ops/pallas/gsa_attention.py:68"),
    }

    # 4a. Warm-up request.
    t0 = time.perf_counter()
    fn(imgs, projs, dv)
    torch.cuda.synchronize()
    print(f"warm-up request: {time.perf_counter() - t0:.3f} s")

    # 4b. Timed requests. Each drives the main path once: every launch count
    # is set to 0 just before it and read just after it.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        depth, conf, stage_confs = fn(imgs, projs, dv)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_request"]:
                raise RuntimeError(f"{name}: {counts.get(name, 0)} launches in a request, "
                                   f"want {spec['per_request']}")
        launches = launches or counts
    print(f"launches per request, the same in each of {N_REQUESTS} requests: {launches}")
    for i, t in enumerate(times):
        print(f"request {i}: {t * 1e3:.2f} ms, {B / t:.4f} depth-maps/s [{card}]")
    mean_s = sum(times) / len(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"mean request: {mean_s * 1e3:.2f} ms, {B / mean_s:.4f} depth-maps/s, "
          f"peak memory {peak_gb:.2f} GB (timed requests) [{card}]")

    # 4c. One more request, recording each kernel's inputs at every call and
    # the TF32 flags the forward runs under (it must turn them off: the model
    # is fp32, and phase 7 checks it at fp32).
    recorded = {name: [] for name in specs}
    tf32_seen = set()

    def recorder(name, fn_):
        def wrapped(*args, **kwargs):
            recorded[name].append((args, kwargs))
            tf32_seen.add((torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
            return fn_(*args, **kwargs)
        return wrapped

    originals = {name: getattr(spec["owner"], name) for name, spec in specs.items()}
    for name, spec in specs.items():
        setattr(spec["owner"], name, recorder(name, originals[name]))
    try:
        fn(imgs, projs, dv)
        torch.cuda.synchronize()
    finally:
        for name, spec in specs.items():
            setattr(spec["owner"], name, originals[name])
    for name, calls in recorded.items():
        if len(calls) != specs[name]["per_request"]:
            raise RuntimeError(f"{name}: recorded {len(calls)} calls, "
                               f"want {specs[name]['per_request']}")
    print(f"tf32 (matmul, cudnn): {torch.backends.cuda.matmul.allow_tf32}, "
          f"{torch.backends.cudnn.allow_tf32} outside the forward, "
          f"{sorted(tf32_seen)} inside it")
    if tf32_seen != {(False, False)}:
        raise RuntimeError("the fp32 forward ran with TF32 on")

    # 4d. Where the device time goes in one request (not counted above).
    layers = layer_breakdown(torch, model, fn, (imgs, projs, dv))
    print("layers (device ms, one request): " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    busy_ms, wall_ms, top = device_busy(torch, fn, (imgs, projs, dv))
    if busy_ms is None:
        print(f"profiled request: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"profiled request: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 5. Outputs.
    if tuple(depth.shape) != (B, H, W) or tuple(conf.shape) != (B, H, W):
        raise RuntimeError(f"output shapes {tuple(depth.shape)}, {tuple(conf.shape)}")
    if not (torch.isfinite(depth).all() and torch.isfinite(conf).all()):
        raise RuntimeError("non-finite depth or confidence")
    dmin, dmax = float(depth.min()), float(depth.max())
    if dmin < DEPTH_MIN or dmax > DEPTH_MAX:
        raise RuntimeError(f"depth range [{dmin}, {dmax}] outside [{DEPTH_MIN}, {DEPTH_MAX}]")
    cmin, cmax = float(conf.min()), float(conf.max())
    if cmin <= 0.0 or cmax > 1.0:
        raise RuntimeError(f"confidence range [{cmin}, {cmax}] outside (0, 1]")
    for s, (args, _) in enumerate(recorded["depth_decode"]):
        dv_s = args[1]
        with torch.inference_mode():
            d_s, _ = originals["depth_decode"](*args)
        lo, hi = float(dv_s.min()), float(dv_s.max())
        if float(d_s.min()) < lo - 1e-3 or float(d_s.max()) > hi + 1e-3:
            raise RuntimeError(f"stage {s + 1}: depth outside its hypotheses [{lo}, {hi}]")
    print(f"outputs ok: depth [{dmin:.3f}, {dmax:.3f}], conf [{cmin:.6f}, {cmax:.6f}]")

    # 6. Kernels against their plain versions, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def check(name, label, args, kwargs):
        spec = specs[name]
        with torch.inference_mode():
            got = spec["kernel"](*args, **kwargs)
            want = spec["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            ok, err, detail, tol = spec["compare"](got, want)
            ms = time_ms(torch, lambda: spec["kernel"](*args, **kwargs))
            plain_ms = time_ms(torch, lambda: spec["plain"](*args, **kwargs), reps=3)
            lib_ms = None
            if "library" in spec:
                lib, to_plain = spec["library"](torch, args)
                lib_ms = time_ms(torch, lib)
                detail += f"; library call max_abs_err {max_err(to_plain(lib()), want):.3e}"
        nbytes, flops = spec["cost"](args, kwargs)
        b_ms, b_by = bound_ms(nbytes, flops)
        lib_text = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        print(f"{name} {label}: max_abs_err {detail} (tolerance {tol}) "
              f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_text}, "
              f"bound {b_ms:.4f} ms ({b_by}) [{card}]", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: kernel disagrees with its plain version")
        return dict(label=label, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)

    per_call = {name: [check(name, call_label(name, i, args), args, kwargs)
                       for i, (args, kwargs) in enumerate(calls)]
                for name, calls in recorded.items()}
    ref, src, src_projs, ref_proj, dv4 = recorded["warp_group_corr"][-1][0][:5]
    one_view = check("warp_group_corr", "stage4 V=1",
                     (ref, src[:, :1].contiguous(), src_projs[:, :1].contiguous(),
                      ref_proj, dv4), recorded["warp_group_corr"][-1][1])

    # 7. End to end against the plain versions on the CPU, small request.
    e2e = small_request_errors(torch, model, make_infer_fn)
    e2e_ok = all(e <= (E2E_DEPTH_ATOL if k == "refined_depth" else E2E_CONF_ATOL)
                 for k, e in e2e.items())
    print(f"request {E2E_SHAPE} on the card against the CPU: max_abs_err "
          + ", ".join(f"{k} {e:.3e}" for k, e in e2e.items())
          + f" (tolerance depth {E2E_DEPTH_ATOL:g}, confidence {E2E_CONF_ATOL:g}) "
          + ("ok" if e2e_ok else "FAILED"), flush=True)
    if not e2e_ok:
        raise RuntimeError("the forward on the card disagrees with the CPU forward")

    kernels = []
    for name, spec in specs.items():
        rows = per_call[name]
        t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
        t_ops = sum(r["flops"] for r in rows) / FP32_FLOPS_PER_S
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (sum(r["library_ms"] for r in rows) if "library" in spec else None),
        })
    details = {
        "card": card, "device": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s,
        "request_ms": [t * 1e3 for t in times], "depth_maps_per_s": B / mean_s,
        "peak_memory_gb": peak_gb, "launches": launches, "layers_ms": layers,
        "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
        "per_call": per_call, "k1_one_view": one_view, "e2e_small_errors": e2e,
        "shape": {"B": B, "V": V, "H": H, "W": W, "depths": NDEPTH_FULL},
    }
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
