"""Phase 15f's CPU bf16 reference step, repeated, with oneDNN on and off.

    python -m mvsformer_torch.bf16_cpu_check [--runs 8]

Run from the repository's root: it reads `chip_smoke.py`'s step shape and
synthetic batch. Builds the model of `chip_smoke.py`'s phase 15f (the
default Config, drop path 0, seed 2) in bf16 on the CPU and runs its
training step `--runs` times with PyTorch's oneDNN (mkldnn) kernels
enabled, then as many times with them disabled. The weights and inputs are
the same in every run, so every run should print the same gradient norms
per layer group, up to the order of parallel sums; norms that spread
further, or are not finite, show a CPU kernel that is not right. Prints
each run's norms and its three largest gradient entries, and per setting
the runs with a non-finite norm and each group's spread over the others.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

GROUPS = ("encoder", "vit", "decoder", "fusions.0", "fusions.1", "fusions.2", "fusions.3")


def one_step(cs, state, cfg, mkldnn: bool):
    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.train.step import TrainStep

    model = build_model(cfg.arch, device="cpu", train=True, dtype=torch.bfloat16)
    model.load_state_dict(state)
    b, v, h, w = cs.STEP_SHAPE
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        TrainStep(model, cfg, seed=0)(cs.synthetic_batch(torch, b, v, h, w, device="cpu",
                                                          with_gt=True))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    norms = {g: float(torch.cat([t.reshape(-1) for n, t in grads.items()
                                 if n.startswith(g + ".")]).float().norm()) for g in GROUPS}
    top = sorted(((float(t.abs().max()), n) for n, t in grads.items()), reverse=True)[:3]
    return time.perf_counter() - t0, norms, top


def main(argv=None) -> int:
    import chip_smoke as cs
    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = Config()
    cfg.arch.vit_args.drop_path_rate = 0.0
    cfg.optimizer.warmup_steps = 0
    cfg.data.multi_scale_args.scale_batch_map = {str(cs.STEP_SHAPE[2]): 1}
    model = build_model(cfg.arch, device="cpu", train=True, dtype=torch.bfloat16)
    random_init_(model, torch.Generator().manual_seed(2))
    state = model.state_dict()
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads, oneDNN "
          f"{torch.backends.mkldnn.is_available()}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}", flush=True)
    for mkldnn in (True, False):
        setting, finite = "on" if mkldnn else "off", []
        for i in range(args.runs):
            sec, norms, top = one_step(cs, state, cfg, mkldnn)
            ok = all(math.isfinite(x) for x in norms.values())
            finite += [norms] if ok else []
            print(f"oneDNN {setting}, run {i}: {sec:.1f} s; "
                  + ", ".join(f"{g} {x:.6g}" for g, x in norms.items())
                  + f"; largest {top}" + ("" if ok else " NOT FINITE"), flush=True)
        spread = {g: (max(n[g] for n in finite) - min(n[g] for n in finite))
                  / min(n[g] for n in finite) for g in GROUPS} if finite else {}
        print(f"oneDNN {setting}: {args.runs - len(finite)} of {args.runs} runs with a "
              f"non-finite norm; each group's (max - min) / min over the finite runs: "
              + ", ".join(f"{g} {x:.3g}" for g, x in spread.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
