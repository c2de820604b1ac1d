#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Print the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel from `mvsformer_torch/csrc/` (one nvcc per
   source, all at once) and print the build time, each kernel's ptxas
   registers and spills, K5's resident blocks per SM at each level (its
   design needs two), K2's (its design needs three) and K1's and K7's at
   each DTU stage (their design needs four), K8's at each stage of the
   training step (three or more), K4's (its design needs two) and K6's
   (its design needs four).
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
   recorded request (K1-K3 at each of the 4 stages, and K1 twice more: at
   stage 4 with V=1, the one-view form, and at stage 1 with B=2, the
   recorded sample beside a second one with its own depths and cameras;
   K4 once; K5 at each FPN level; K6 at each GSA block), and time both; for
   K6 also time scaled_dot_product_attention on the same inputs as the
   library yardstick. Print K1's time per stage.
7. Run the __graft_entry__ request (B=1, 3 views, 128x128, 192 depths) on
   the card and, with the same weights, on the CPU (the plain versions),
   TF32 off, and compare depth and confidences.
8. Train TwinMVSNet at the JAX package's training shape: the default
   Config (drop path 0.2 from a seeded CUDA generator, AdamW with the twin
   LR split and warmup-cosine), B=8 as 2 micro-batches of 4
   (`scale_batch_map["512"]`), 5 views, 512x640, 192 depths, the cameras
   above and a depth_gt/mask per stage as `_synthetic_batch(with_gt=True)`
   builds them, random weights from a seeded torch.Generator. One warm-up
   step, then 3 timed steps through `train.step.TrainStep`, each with the
   launch counts set to 0 just before it and read just after it: K7
   `warp_corr_fwd` and K8 `warp_corr_bwd` launch 4 times per micro-batch
   (8 per step), K1-K6 never. Loss and every gradient must be finite and
   every trainable tensor's gradient non-zero. One more step is timed
   layer by layer, forward and backward, under torch.profiler (the
   device's idle share and top kernels), and one records the tensors it
   feeds K7 and K8.
9. With TF32 off, hold K7 and K8 against their plain versions on the card
   at each of those 8 + 8 launches, and time both; hold K8 once more at
   stage 1 with every source camera zoomed 3 times, where neighbouring
   pixels' taps lie 3 source pixels apart and a pixel's tap square moves at
   almost every depth, so its sums over depths hardly merge. Print K7's and
   K8's time per stage.
10. Run one fp32 training step (the __graft_entry__ request's cameras,
   B=2 as 2 micro-batches, 3 views, 128x128, 192 depths, drop path 0, no
   warmup) on the card and, with the same weights and batch, on the CPU,
   and compare the losses, the gradients, the BN running statistics and
   the updated parameters.
11. Print one JSON line of per-kernel numbers, then, last, the result line
   {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Bounds: the larger of bytes moved (each input read once, each output
written once) over 3.35 TB/s and operations over 67 TFLOP/s (fp32 outside
the tensor cores), the published H100 SXM peaks. K2 runs layers 1 and 2
and K5 its 3x3 conv on the tensor cores in 3xTF32 (three TF32 products per
multiply-add, which keeps fp32's accuracy), so their bounds have a third
term: 3 x 2 x those multiply-adds over 494.7 TFLOP/s (dense TF32), with
their other operations over 67 TFLOP/s; their lines name the term that
binds ("bytes", "tensor" or "operations") and the kernel's share of the
bound. K4 runs all three of its convs that way, and K6 both products of
its attention (the softmax's operations stay on the fp32 term). A kernel's
entry in the kernels line sums the bounds of its launches, and names the
tensor term "operations".
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12
TF32_PRODUCTS = 3  # 3xTF32: lo*hi + hi*lo + hi*hi per multiply-add
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
# K2: ~3.6k multiply-adds per pixel summed in another order than cuDNN's,
#     layers 1-2 in 3xTF32 (fp32's accuracy; one TF32 product would read
#     ~1.7e-4, tests/test_torch_vis_tf32.py).
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
# K6: fp32 logits and probabilities on both sides, both products in
#     3xTF32 (fp32's accuracy: tests/test_torch_gsa_tf32.py); the kernel's
#     online softmax rescales its sums per 64-key tile, the plain version
#     divides once.
K6_RTOL_OF_SCALE = 1e-5   # of max(1, max |output|): a convex mix of v rows
# End to end, the forward on the card (kernels, cuDNN, cuBLAS) against the
# same weights on the CPU (plain versions) at the __graft_entry__ request,
# TF32 off: the bounds tests/test_torch_model.py holds the port to against
# the JAX model (sums in another order, through four stages of decode).
E2E_SHAPE = (1, 3, 128, 128)  # B, V, H, W
E2E_DEPTH_ATOL = 1e-2         # depth units over the 425-900 range
E2E_CONF_ATOL = 1e-4

# Training: the JAX package's training shape (DataConfig: batch_size 8,
# scale_batch_map["512"] 4, nviews 5, 512x640, 192 depths).
TRAIN_B, TRAIN_MICRO, TRAIN_V, TRAIN_H, TRAIN_W = 8, 4, 5, 512, 640
N_STEPS = 3
# K7: K1's kernel body without the entropy; the same bound as K1's corr.
K7_RTOL_OF_SCALE = 1e-4   # of max(1, max |corr|)
# K8: each dsrc entry sums up to 4*D terms and each dref entry V*D, in
#     registers and then by fp32 vector reductions in an order that varies
#     from run to run; the plain version sums the same products through
#     autograd's scatter.
K8_RTOL_OF_SCALE = 1e-5   # per output (dref, dsrc), of its max |value|
# One training step on the card against the CPU, fp32 with TF32 off (the
# kernels take fp32 only). A tiny randomly initialised network amplifies
# fp32 rounding in its gradients: on the CPU the JAX model's move by up to
# 5.3e-2 of a tensor's largest entry when the images move by 1e-6 of their
# value, and by 9.2e-5 in float64 (`python -m tests.test_torch_train_step`
# prints both). So the gradient bounds here are measured ones, not the
# float64 CPU test's: the card read 4.05e-2 of scale and 1.04e-2 in L2 (an
# H100 80GB HBM3 at 700 W).
STEP_SHAPE = (2, 3, 128, 128)  # B (2 micro-batches of 1), V, H, W
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_OF_SCALE = 5e-2      # |card - cpu| <= 5e-4 + this * max|cpu|, per tensor
STEP_GRAD_L2 = 3e-2            # ||card - cpu|| <= this * ||cpu|| where ||cpu|| > 1e-4
STEP_STATS_RTOL, STEP_STATS_ATOL = 1e-4, 1e-5
STEP_UPDATE_OF_LR = 1e-2       # where the gradient's sign is certain


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_request(torch, b=B, v_=V, h=H, w=W, device="cuda"):
    """__graft_entry__._synthetic_batch (DTU eval shape by default), as tensors."""
    batch = synthetic_batch(torch, b, v_, h, w, device)
    return batch["imgs"], batch["proj_matrices"], batch["depth_values"]


def synthetic_batch(torch, b, v_, h, w, device="cuda", with_gt=False):
    """__graft_entry__._synthetic_batch as a dict of tensors: imgs,
    proj_matrices, depth_values and, with_gt, depth_gt and mask per stage."""
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
    batch = {"imgs": torch.from_numpy(imgs).to(device), "proj_matrices": projs,
             "depth_values": torch.from_numpy(dv).to(device)}
    if with_gt:
        gt, mask = {}, {}
        for s, scale in zip(range(1, 5), (8, 4, 2, 1)):
            gt[f"stage{s}"] = torch.from_numpy(
                rng.uniform(430, 890, (b, h // scale, w // scale)).astype(np.float32)).to(device)
            mask[f"stage{s}"] = torch.ones((b, h // scale, w // scale), device=device)
        batch["depth_gt"], batch["mask"] = gt, mask
    return batch


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


def k1_two_samples(torch, ref, src, src_projs, ref_proj, dv):
    """K1's inputs at B=2: the recorded sample, and beside it a second one
    with its source views in reverse order (other cameras for each view) and
    its depths moved to 1.15 d + 30 (another range)."""
    flip = lambda t: t.flip(1)
    return (torch.cat([ref, ref.flip(2)]).contiguous(),
            torch.cat([src, flip(src)]).contiguous(),
            torch.cat([src_projs, flip(src_projs)]).contiguous(),
            torch.cat([ref_proj, ref_proj]).contiguous(),
            torch.cat([dv, dv * 1.15 + 30.0]).contiguous())


def k2_cost(args, kwargs):
    ent = args[0]
    n, h, w = ent.shape
    nbytes = 4 * (2 * n * h * w + 3689)
    # Outside the tensor cores, per pixel: layer 0's and the head's
    # multiply-adds, BN and ReLU on 40 channels, the bias and the sigmoid.
    # On them: layers 1 and 2, 144 x 16 + 144 x 8 multiply-adds.
    return nbytes, n * h * w * (2 * (9 * 16 + 8) + 3 * 40 + 4), n * h * w * 144 * 24


def k3_cost(args, kwargs):
    logits = args[0]
    b, d, h, w = logits.shape
    return 4 * (2 * b * d * h * w + 2 * b * h * w), b * h * w * d * 10


def k4_cost(args, kwargs):
    n, _, h, w = args[0].shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    nbytes = 4 * (n * 3 * h * w + n * 8 * h * w + n * 16 * ho * wo + 6040)
    # Outside the tensor cores: BN (2) and lrelu (1) per output of the
    # three layers. On them: the three convs' multiply-adds.
    macs = n * h * w * (7 * 7 * 3 * 8 + 5 * 5 * 8 * 8) + n * ho * wo * 5 * 5 * 8 * 16
    return nbytes, 3 * (2 * n * 8 * h * w + n * 16 * ho * wo), macs


def k5_cost(args, kwargs):
    prev, lat, _, _, k3 = args[:5]
    n, _, h, w = prev.shape
    cl, co, hw = lat.shape[1], k3.shape[0], 4 * h * w
    emit = kwargs.get("emit_intra", False)
    nbytes = 4 * (prev.numel() + lat.numel() + n * co * hw + (n * 64 * hw if emit else 0)
                  + 64 * (cl + 1) + co * (576 + 3))
    # Outside the tensor cores, per pixel: the 1x1 multiply-adds, ~10 ops
    # per channel for the align-corners lerp and the bias, ~8 per output for
    # bias, BN and swish. On them: the 3x3 conv's multiply-adds.
    return nbytes, n * hw * (2 * 64 * cl + 64 * 10 + co * 8), n * hw * 576 * co


def k6_cost(args, kwargs):
    q, k, _, nh = args
    b, n, c = q.shape
    nk = k.shape[1]
    # Outside the tensor cores: ~5 ops per logit for the scale and the
    # online softmax. On them: the two products' multiply-adds.
    return (4 * (2 * b * n * c + 2 * b * nk * c), 5 * b * nh * n * nk,
            2 * b * n * nk * c)


def k7_cost(args, kwargs):
    ref, src, _, _, dv = args[:5]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    nbytes = 4 * (b * hw * c + b * v * hw * c + b * d * hw + b * v * 16 + b * 16
                  + b * v * g * d * hw)
    # per (view, depth, pixel): ~30 coordinate/weight ops, 4 taps x C FMAs,
    # C FMAs for the products, G means.
    return nbytes, b * v * d * hw * (30 + 8 * c + 2 * c + g)


def k8_cost(args, kwargs):
    ref, src, _, _, dv, dcorr = args[:6]
    b, v, h, w, c = src.shape
    d, g, hw = dv.shape[1], 8, h * w
    # reads ref, src, dv, dcorr and the cameras; writes dref and dsrc.
    nbytes = 4 * (2 * b * hw * c + 2 * b * v * hw * c + b * d * hw + dcorr.numel()
                  + b * v * 16 + b * 16)
    # per (view, depth, pixel): ~30 coordinate/weight ops, the warped vector
    # again (4 taps x C FMAs), C FMAs into dref, the C products ref * dcex
    # once, then per tap and channel a product and an add into dsrc.
    return nbytes, b * v * d * hw * (30 + 8 * c + 2 * c + c + 8 * c + g)


def k8_zoomed(torch, args):
    """K8's inputs with every source camera zoomed 3 times about the image
    centre: neighbouring pixels' taps lie 3 source pixels apart, and only
    the middle third of the reference view lands in the source."""
    ref, src, src_projs, *rest = args
    h, w = src.shape[2:4]
    zoom = torch.eye(4, dtype=src_projs.dtype, device=src_projs.device)
    zoom[0, 0] = zoom[1, 1] = 3.0
    zoom[0, 2], zoom[1, 2] = -float(w - 1), -float(h - 1)
    return (ref, src, (zoom @ src_projs).contiguous(), *rest)


def bound_ms(nbytes, flops, tensor_macs=0):
    """(least ms, the term that binds): bytes over the memory rate, fp32
    operations over the CUDA cores' rate and, for a kernel on the tensor
    cores (K2, K4, K5, K6), its 3xTF32 products over the dense TF32 rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / FP32_FLOPS_PER_S,
             "tensor": TF32_PRODUCTS * 2 * tensor_macs / TF32_FLOPS_PER_S}
    by = max(times, key=times.get)  # ties go to bytes, then operations
    return times[by] * 1e3, by


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
    busy_ms, top = kernel_times(torch, prof)
    return busy_ms, wall_ms, top


def kernel_times(torch, prof):
    """(device kernel ms, the 12 kernels that took longest) of a profile;
    (None, []) when the profiler saw no device events."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    if not by_name:
        return None, []
    return sum(by_name.values()), sorted(by_name.items(), key=lambda kv: -kv[1])[:12]


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


def rel_compare(rtol_of_scale, names, floor=1.0):
    """Compare outputs one by one: |got - want| <= rtol * max(floor, max|want|).
    A floor of 0 makes the bound relative to the output's own scale, for
    outputs whose scale follows their inputs' (a gradient of a mean over many
    pixels is small)."""
    def compare(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok, err, parts = True, 0.0, []
        for name, g, w in zip(names, got, want):
            e, allowed = max_err(g, w), rtol_of_scale * max(floor, float(w.abs().max()))
            ok, err = ok and e <= allowed, max(err, e)
            parts.append(f"{name} {e:.3e} (<= {allowed:.3e})")
        return (ok, err, ", ".join(parts),
                f"{rtol_of_scale:g} of max({floor:g}, max |output|)" if floor
                else f"{rtol_of_scale:g} of max |output|")
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
    if name == "warp_corr_bwd":  # the backward meets the stages in reverse
        return f"stage{4 - i}"
    return f"stage{i + 1}"


def check_kernel(torch, card, name, spec, label, args, kwargs):
    """Hold one launch of a kernel against its plain version on the same
    inputs, and time both (and the library call, where there is one)."""
    with torch.no_grad():
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
    nbytes, flops, *tensor = spec["cost"](args, kwargs)
    tensor_macs = tensor[0] if tensor else 0
    b_ms, b_by = bound_ms(nbytes, flops, tensor_macs)
    lib_text = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    share = f", {b_ms / ms:.1%} of it" if tensor else ""
    print(f"{name} {label}: max_abs_err {detail} (tolerance {tol}) "
          f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_text}, "
          f"bound {b_ms:.4f} ms ({b_by}){share} [{card}]", flush=True)
    if not ok:
        raise RuntimeError(f"{name} {label}: kernel disagrees with its plain version")
    return dict(label=label, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                tensor_macs=tensor_macs)


def kernel_row(name, spec, rows, launches):
    """One entry of the kernels JSON line, summed over the checked launches:
    the bound is the sum of the launches' bounds, and bound_by the term
    that binds the most of it (the tensor cores' term counts as
    operations)."""
    by_term = {}
    for r in rows:
        term = "operations" if r["bound_by"] == "tensor" else r["bound_by"]
        by_term[term] = by_term.get(term, 0.0) + r["bound_ms"]
    return {
        "name": name, "route": spec["route"], "source": spec["source"],
        "replaces": spec["replaces"], "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(by_term.values()),
        "bound_by": max(by_term, key=by_term.get),
        "library_ms": (sum(r["library_ms"] for r in rows) if "library" in spec else None),
    }


def train_layer_breakdown(torch, model, step, batch):
    """Device time per layer in one training step, under torch.profiler.

    Forward: CUDA events on forward pre/post hooks, as `layer_breakdown`.
    Backward: the device time of the kernels each autograd node launches
    (the profiler's record of that node, matched by its sequence number),
    given to the layer whose forward made the node: a layer's nodes are
    those reachable from its outputs without passing its inputs or a
    parameter's gradient accumulator. A nested layer (a stage's visibility
    CNN and cost regulariser) counts inside its stage as well. The
    optimizer step is spanned by CUDA events on the optimizer's hooks.
    Returns (split, kernel ms, wall ms, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    nst = len(model.fusions)
    top = ["encoder", "vit", "decoder_vit", "decoder"] + [f"fusions.{i}" for i in range(nst)]
    names = top + [f"fusions.{i}.{sub}" for i in range(nst) for sub in ("vis", "cost_reg")]
    modules = dict(model.named_modules())
    fwd = {n: [] for n in names}
    owner, inputs, hooks = {}, {}, []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x] if x.grad_fn is not None else []
        if isinstance(x, (list, tuple)):
            return [t for y in x for t in tensors(y)]
        if isinstance(x, dict):
            return [t for y in x.values() for t in tensors(y)]
        return []

    def claim(name, outs, ins):
        stop = {t.grad_fn for t in ins}
        seen, todo = set(), [t.grad_fn for t in outs]
        while todo:
            node = todo.pop()
            if node is None or node in seen or node in stop or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(node)
            owner.setdefault(node._sequence_nr(), name)  # an inner layer claims first
            todo.extend(f for f, _ in node.next_functions)

    for name in names:
        def pre(mod, args, name=name):
            fwd[name].append([event(), None])
            inputs[name] = tensors(args)

        def post(mod, args, out, name=name):
            fwd[name][-1][1] = event()
            claim(name, tensors(out), inputs.pop(name))
        hooks += [modules[name].register_forward_pre_hook(pre),
                  modules[name].register_forward_hook(post)]
    opt = []
    hooks += [step.optimizer.register_step_pre_hook(lambda *a: opt.append(event())),
              step.optimizer.register_step_post_hook(lambda *a: opt.append(event()))]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start = event()
            step(batch)
            end = event()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    backward = {n: 0.0 for n in names}
    for e in prof.events():
        if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in owner:
            o = owner[e.sequence_nr]
            for n in names:
                if o == n or o.startswith(n + "."):
                    backward[n] += e.device_time_total / 1e3
    out = {"forward": {n: sum(a.elapsed_time(b) for a, b in fwd[n]) for n in names},
           "backward (kernels)": backward}
    out["optimizer"] = opt[0].elapsed_time(opt[-1])
    out["total"] = start.elapsed_time(end)
    out["other (resizes, hypotheses, loss, view split, gradient accumulation, idle)"] = (
        out["total"] - out["optimizer"]
        - sum(out["forward"][n] + backward[n] for n in top))
    kernel_ms, top_kernels = kernel_times(torch, prof)
    return out, kernel_ms, wall_ms, top_kernels


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def compare_steps(torch, card_model, cpu_model, before, card_metrics, cpu_metrics, opt_cfg):
    """Card against CPU after one training step from the same weights:
    (ok, {what: worst error}, message lines)."""
    lines, errs, ok = [], {}, True
    for k, v in cpu_metrics.items():
        if k.startswith("loss"):
            e = abs(card_metrics[k] - v)
            errs[k] = e
            if e > STEP_LOSS_RTOL * abs(v):
                ok = False
                lines.append(f"{k}: card {card_metrics[k]:.7f}, cpu {v:.7f}")
    card_g, cpu_g = grads_of(card_model), grads_of(cpu_model)
    worst_scale, worst_l2, worst_at = 0.0, 0.0, None
    for n, want in cpu_g.items():
        got = card_g[n].cpu()
        e = float((got - want).abs().max())
        scale = float(want.abs().max())
        if e > 5e-4 + STEP_GRAD_OF_SCALE * scale:
            ok = False
            lines.append(f"grad {n}: max error {e:.3e}, scale {scale:.3e}")
        norm = float(want.norm())
        if norm > 1e-4:  # the worst errors are reported where the gradient is not ~0
            if e / scale > worst_scale:
                worst_scale, worst_at = e / scale, n
            rel = float((got - want).norm()) / norm
            worst_l2 = max(worst_l2, rel)
            if rel > STEP_GRAD_L2:
                ok = False
                lines.append(f"grad {n}: L2 error {rel:.3e} of its norm")
    errs["grad_of_scale"], errs["grad_l2"] = worst_scale, worst_l2
    lines.append(f"largest gradient error, of its tensor's scale: {worst_scale:.3e} at {worst_at}")
    card_b, worst_stat = dict(card_model.named_buffers()), 0.0
    for n, want in cpu_model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            e = (card_b[n].cpu() - want).abs()
            worst_stat = max(worst_stat, float(e.max()))
            if bool((e > STEP_STATS_ATOL + STEP_STATS_RTOL * want.abs()).any()):
                ok = False
                lines.append(f"running stat {n}: max error {float(e.max()):.3e}")
    errs["running_stats"] = worst_stat
    card_p, worst_upd = dict(card_model.named_parameters()), 0.0
    for n, p in cpu_model.named_parameters():
        lr = opt_cfg.vit_lr if n.startswith("vit.") else opt_cfg.lr
        got = card_p[n].detach().cpu() - before[n]
        want = p.detach() - before[n]
        g = cpu_g[n]
        pmax = float(before[n].abs().max())
        ulps = 2.5e-7 * max(1.0, pmax)  # two fp32 roundings of the weight
        if float(g.norm()) > 1e-4:
            sure = g.abs() >= 0.1 * g.abs().max()
            e = float((got[sure] - want[sure]).abs().max())
            worst_upd = max(worst_upd, e / lr)
            if e > STEP_UPDATE_OF_LR * lr + ulps:
                ok = False
                lines.append(f"update {n}: max error {e:.3e} where the gradient sign is certain")
        bound = lr * (1 + opt_cfg.weight_decay * pmax) + ulps
        if float(got.abs().max()) > bound:
            ok = False
            lines.append(f"update {n}: moved {float(got.abs().max()):.3e}, more than one step")
    errs["update_of_lr"] = worst_upd
    return ok, errs, lines


def training_phase(torch, card, eval_kernels):
    """Phases 8-10. Returns the details, with the K7/K8 rows of the kernels
    line under "kernels"."""
    import copy

    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.ops import cuda_build, warp_corr, warp_corr_train
    from mvsformer_torch.train.step import TrainStep

    cfg = Config()
    sbm = cfg.data.multi_scale_args.scale_batch_map
    if cfg.data.batch_size != TRAIN_B or int(sbm[str(TRAIN_H)]) != TRAIN_MICRO:
        raise RuntimeError("the default DataConfig no longer gives the training shape")
    n_micro = TRAIN_B // TRAIN_MICRO
    nstages = len(cfg.arch.ndepths)
    specs = {
        "warp_corr_fwd": dict(
            kernel=warp_corr.warp_corr_fwd, plain=warp_corr.warp_corr_fwd_plain,
            owner=warp_corr_train, per_step=nstages * n_micro, cost=k7_cost,
            compare=rel_compare(K7_RTOL_OF_SCALE, ("corr",)),
            route="cuda", source="mvsformer_torch/csrc/warp_corr.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr.py:694"),
        "warp_corr_bwd": dict(
            kernel=warp_corr_train.warp_corr_bwd, plain=warp_corr_train.warp_corr_bwd_plain,
            owner=warp_corr_train, per_step=nstages * n_micro, cost=k8_cost,
            compare=rel_compare(K8_RTOL_OF_SCALE, ("dref", "dsrc"), floor=0.0),
            route="cuda", source="mvsformer_torch/csrc/warp_corr_bwd.cu",
            replaces="mvsformer_tpu/ops/pallas/warp_corr_bwd.py:197"),
    }

    # 8a. The model, the optimizer and the batch.
    t0 = time.perf_counter()
    model = build_model(cfg.arch, device="cuda", train=True)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    batch = synthetic_batch(torch, TRAIN_B, TRAIN_V, TRAIN_H, TRAIN_W, with_gt=True)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    print(f"training: TwinMVSNet alt_gvt_small fp32, drop path "
          f"{model.vit.blocks[-1][-1].drop_path_rate:.2f} at the last block, "
          f"{len(trainable)} trainable tensors, B={TRAIN_B} as {n_micro} micro-batches of "
          f"{TRAIN_MICRO}, {TRAIN_V} views, {TRAIN_H}x{TRAIN_W}, {NDEPTH_FULL} depths; "
          f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    print(f"warm-up step: {time.perf_counter() - t0:.3f} s")

    # 8b. Timed steps, each driving the training path once.
    torch.cuda.reset_peak_memory_stats()
    times, launches, metrics = [], None, []
    for _ in range(N_STEPS):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        metrics.append(step(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(cuda_build.LAUNCHES)
        for name, spec in specs.items():
            if counts.get(name, 0) != spec["per_step"]:
                raise RuntimeError(f"{name}: {counts.get(name, 0)} launches in a training "
                                   f"step, want {spec['per_step']}")
        ran = {n: counts[n] for n in eval_kernels if counts.get(n, 0)}
        if ran:
            raise RuntimeError(f"eval-only kernels launched in a training step: {ran}")
        launches = launches or counts
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_s = sum(times) / len(times)
    print(f"launches per training step, the same in each of {N_STEPS} steps: {launches}")
    for i, (t, m) in enumerate(zip(times, metrics)):
        print(f"step {i}: {t * 1e3:.2f} ms, loss {m['loss']:.5f} ("
              + ", ".join(f"{k[5:]} {m[k]:.5f}" for k in m if k.startswith("loss_"))
              + f"), grad norm {m['grad_norm']:.5f}, lr {m['lr']:.3e} [{card}]")
    print(f"mean training step: {mean_s * 1e3:.2f} ms, {1 / mean_s:.4f} train-steps/s, "
          f"{TRAIN_B / mean_s:.3f} samples/s, peak memory {peak_gb:.2f} GB (timed steps) [{card}]")

    # 8c. The last step's loss and gradients.
    import math

    if not all(math.isfinite(v) for m in metrics for k, v in m.items() if k.startswith("loss")):
        raise RuntimeError("non-finite training loss")
    bad = [n for n, g in grads_of(model).items()
           if g is None or not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    if bad:
        raise RuntimeError(f"{len(bad)} trainable tensors with a missing, non-finite or "
                           f"all-zero gradient: {bad[:8]}")
    print(f"gradients: all {len(trainable)} trainable tensors finite and non-zero")

    # 8d. Layer split of one step, and the device's idle share.
    layers, busy_ms, wall_ms, top = train_layer_breakdown(torch, model, step, batch)
    print("training step layers (device ms): " + json.dumps(
        {k: ({n: round(t, 3) for n, t in v.items()} if isinstance(v, dict) else round(v, 3))
         for k, v in layers.items()}))
    if busy_ms is None:
        print(f"profiled training step: {wall_ms:.2f} ms wall; device busy share not measured "
              f"(the profiler saw no device events)")
    else:
        print(f"profiled training step: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of kernels, "
              f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} [{card}]")
        for name, t in top:
            print(f"  {t:9.3f} ms  {name[:110]}")

    # 8e. One more step, recording the tensors it feeds K7 and K8 at every
    # launch (the Function calls them through warp_corr_train's globals).
    recorded = {name: [] for name in specs}
    originals = {name: getattr(warp_corr_train, name) for name in specs}

    def recorder(name):
        def wrapped(*args, **kwargs):
            recorded[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    for name in specs:
        setattr(warp_corr_train, name, recorder(name))
    try:
        step(batch)
        torch.cuda.synchronize()
    finally:
        for name in specs:
            setattr(warp_corr_train, name, originals[name])

    for name, spec in specs.items():
        if len(recorded[name]) != spec["per_step"]:
            raise RuntimeError(f"{name}: recorded {len(recorded[name])} calls, "
                               f"want {spec['per_step']}")

    # 9. K7 and K8 against their plain versions, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_call = {name: [check_kernel(torch, card, name, spec, f"micro{i // nstages + 1} "
                                    + call_label(name, i % nstages, args), args, kwargs)
                       for i, (args, kwargs) in enumerate(recorded[name])]
                for name, spec in specs.items()}
    kernels = [kernel_row(name, spec, per_call[name], launches.get(name, 0))
               for name, spec in specs.items()]
    # K8 at stage 1 of micro-batch 1 (its last launch there) with zoomed sources.
    args, kwargs = recorded["warp_corr_bwd"][nstages - 1]
    k8_zoom = check_kernel(torch, card, "warp_corr_bwd", specs["warp_corr_bwd"],
                           "micro1 stage1 zoomed 3x", k8_zoomed(torch, args), kwargs)
    for name, kernel in (("warp_corr_fwd", "K7"), ("warp_corr_bwd", "K8")):
        ms = [r["ms"] for r in per_call[name]]
        if name == "warp_corr_bwd":  # the backward meets the stages in reverse
            ms = [t for m in range(n_micro) for t in ms[m * nstages:(m + 1) * nstages][::-1]]
        print(f"{name} ({kernel}) ms per stage, "
              + ", ".join(f"micro-batch {m + 1}: " + " / ".join(
                  f"{t:.4f}" for t in ms[m * nstages:(m + 1) * nstages]) for m in range(n_micro))
              + f"; {sum(ms):.4f} per step [{card}]")
    del recorded, model, step, batch
    torch.cuda.empty_cache()

    # 10. One step on the card against the CPU.
    sb, sv, sh, sw = STEP_SHAPE
    small = Config()
    small.arch.vit_args.drop_path_rate = 0.0
    small.optimizer.warmup_steps = 0
    small.data.multi_scale_args.scale_batch_map = {str(sh): 1}
    cpu_model = build_model(small.arch, device="cpu", train=True)
    random_init_(cpu_model, torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(cpu_model).cuda()
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    t0 = time.perf_counter()
    card_metrics = TrainStep(card_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cuda", with_gt=True))
    cpu_metrics = TrainStep(cpu_model, small, seed=0)(
        synthetic_batch(torch, sb, sv, sh, sw, device="cpu", with_gt=True))
    ok, step_errs, lines = compare_steps(torch, card_model, cpu_model, before, card_metrics,
                                         cpu_metrics, small.optimizer)
    print(f"training step {STEP_SHAPE} on the card against the CPU ({time.perf_counter() - t0:.1f}"
          f" s): loss {card_metrics['loss']:.6f} / {cpu_metrics['loss']:.6f}; worst errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in step_errs.items())
          + f" (bounds: loss {STEP_LOSS_RTOL:g} relative; gradients {STEP_GRAD_OF_SCALE:g} of "
          f"scale + 5e-4 and {STEP_GRAD_L2:g} in L2; running stats {STEP_STATS_ATOL:g} + "
          f"{STEP_STATS_RTOL:g} relative; updates {STEP_UPDATE_OF_LR:g} of the LR where the "
          f"gradient sign is certain) " + ("ok" if ok else "FAILED"), flush=True)
    for line in lines[-20:]:
        print(f"  {line}")
    if not ok:
        raise RuntimeError("the training step on the card disagrees with the CPU step")
    return {"kernels": kernels, "step_ms": [t * 1e3 for t in times],
            "train_steps_per_s": 1 / mean_s, "peak_memory_gb": peak_gb, "launches": launches,
            "metrics": metrics, "layers_ms": layers, "per_call": per_call,
            "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
            "card_vs_cpu_step": step_errs, "k8_zoomed": k8_zoom,
            "shape": {"B": TRAIN_B, "micro": TRAIN_MICRO, "V": TRAIN_V, "H": TRAIN_H,
                      "W": TRAIN_W, "depths": NDEPTH_FULL}}


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
    occupancy = {f"{cl}/{co}": cuda_build.library("fpn_level").fpn_level_blocks_per_sm(cl, co)
                 for cl, co in fpn_level.LEVELS}
    print(f"fpn_level resident blocks per SM, by (cl/co): {occupancy}")
    if min(occupancy.values()) < 2:
        raise RuntimeError("fpn_level: fewer than two blocks share an SM")
    vis_blocks = cuda_build.library("vis_net").visibility_net_blocks_per_sm()
    print(f"visibility_net resident blocks per SM: {vis_blocks}")
    if vis_blocks < 3:
        raise RuntimeError("visibility_net: fewer than three blocks share an SM")
    warp_lib = cuda_build.library("warp_corr")
    warp_blocks = {f"{k} C={c} D={d}": warp_lib.warp_corr_blocks_per_sm(c, d, k == "K1")
                   for k in ("K1", "K7") for c, d in ((64, 32), (32, 16), (16, 8), (8, 4))}
    print(f"warp_group_corr (K1) and warp_corr_fwd (K7) resident blocks per SM: {warp_blocks}")
    if min(warp_blocks.values()) < 4:
        raise RuntimeError("warp_corr: fewer than four blocks share an SM")
    bwd_lib = cuda_build.library("warp_corr_bwd")
    bwd_blocks = {f"C={c} D={d}": bwd_lib.warp_corr_bwd_blocks_per_sm(c, d)
                  for c, d in ((64, 32), (32, 16), (16, 8), (8, 4))}
    print(f"warp_corr_bwd (K8) resident blocks per SM: {bwd_blocks}")
    if min(bwd_blocks.values()) < 3:
        raise RuntimeError("warp_corr_bwd: fewer than three blocks share an SM")
    head_blocks = cuda_build.library("encoder_head").encoder_head_blocks_per_sm()
    print(f"encoder_head (K4) resident blocks per SM: {head_blocks}")
    if head_blocks < 2:
        raise RuntimeError("encoder_head: fewer than two blocks share an SM")
    gsa_blocks = cuda_build.library("gsa_attention").gsa_attention_blocks_per_sm()
    print(f"gsa_attention (K6) resident blocks per SM: {gsa_blocks}")
    if gsa_blocks < 4:
        raise RuntimeError("gsa_attention: fewer than four blocks share an SM")

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
            route="cuda", source="mvsformer_torch/csrc/depth_decode.cu",
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
        return check_kernel(torch, card, name, specs[name], label, args, kwargs)

    per_call = {name: [check(name, call_label(name, i, args), args, kwargs)
                       for i, (args, kwargs) in enumerate(calls)]
                for name, calls in recorded.items()}
    ref, src, src_projs, ref_proj, dv4 = recorded["warp_group_corr"][-1][0][:5]
    one_view = check("warp_group_corr", "stage4 V=1",
                     (ref, src[:, :1].contiguous(), src_projs[:, :1].contiguous(),
                      ref_proj, dv4), recorded["warp_group_corr"][-1][1])
    two_samples = check("warp_group_corr", "stage1 B=2",
                        k1_two_samples(torch, *recorded["warp_group_corr"][0][0][:5]),
                        recorded["warp_group_corr"][0][1])
    print("warp_group_corr (K1) ms per stage: "
          + " / ".join(f"{r['ms']:.4f}" for r in per_call["warp_group_corr"])
          + f"; {sum(r['ms'] for r in per_call['warp_group_corr']):.4f} per request [{card}]")
    k6 = per_call["gsa_attention"]
    k6_ms, k6_bound = sum(r["ms"] for r in k6), sum(r["bound_ms"] for r in k6)
    print("gsa_attention (K6) ms per launch: " + " / ".join(f"{r['ms']:.4f}" for r in k6)
          + f"; {k6_ms:.4f} per request, {k6_bound / k6_ms:.1%} of its {k6_bound:.4f} ms "
          f"bound; scaled_dot_product_attention {sum(r['library_ms'] for r in k6):.4f} "
          f"[{card}]")

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

    kernels = [kernel_row(name, spec, per_call[name], launches.get(name, 0))
               for name, spec in specs.items()]

    # 8-10. Training.
    del fn, model, recorded
    torch.cuda.empty_cache()
    train = training_phase(torch, card, eval_kernels=tuple(specs))
    kernels += train.pop("kernels")

    details = {
        "card": card, "device": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "k5_blocks_per_sm": occupancy,
        "k2_blocks_per_sm": vis_blocks, "k4_blocks_per_sm": head_blocks,
        "k6_blocks_per_sm": gsa_blocks,
        "request_ms": [t * 1e3 for t in times], "depth_maps_per_s": B / mean_s,
        "peak_memory_gb": peak_gb, "launches": launches, "layers_ms": layers,
        "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms, "top_kernels": top,
        "per_call": per_call, "k1_one_view": one_view, "k1_two_samples": two_samples,
        "warp_blocks_per_sm": warp_blocks, "k8_blocks_per_sm": bwd_blocks,
        "e2e_small_errors": e2e,
        "shape": {"B": B, "V": V, "H": H, "W": W, "depths": NDEPTH_FULL},
        "training": train,
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
