"""`chip_smoke.py` 17d's remat-against-plain gradient gap, taken apart on a card.

    python -m mvsformer_torch.remat_probe [--runs 3] [--out FILE]

Run from the repository's root on a CUDA card: it reads `chip_smoke.py`'s
step shape, groups and synthetic batch, and builds 17d's model (the
default Config with `multi_scale`, drop path 0.2, weights from seed 1).
Every part runs twice, with cuDNN's default algorithms and with
`cudnn.deterministic` and `torch.use_deterministic_algorithms(True,
warn_only=True)` (the ops that warn are listed):

1. The Twins backbone alone, as a training micro-batch feeds it (20
   images), plain then checkpointed (`mvsformer.remat`) then plain again,
   from one CUDA generator seed and one fixed upstream gradient: whether
   the outputs are bit-equal, the relative L2 of its parameters'
   gradients against the first plain run's, and whether the generator's
   state after the backward is the same.
2. The whole step's forward and backward (TrainStep's micro-batch loop,
   2 micro-batches of 4), `--runs` times with remat off and as many with
   it on, in turns: each micro-batch's loss, how many pixels of each
   stage's depth differ from the first run's (the next stage's window
   moves with them), and per layer group the relative L2 between every
   two runs' gradients after the first micro-batch and after both. The
   deterministic runs end with a wrong remat that checkpoints without
   replaying the generator (`naive_remat`): what such a fault reads.
3. Four `TrainStep` steps each of a plain and a remat model, one after the
   other (the order of 17d), with each step's ms and the caching
   allocator's new device allocations and retries in it.

Prints one JSON line per part and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import time
import warnings

import torch

MODES = ("default", "deterministic")
DEVICE = "cuda"  # `--device cpu` runs it on the CPU (at a small shape, for a try)


@contextlib.contextmanager
def mode(name: str, seen: set):
    """cuDNN's default algorithms, or deterministic ones with the ops that
    have none named in `seen`."""
    if name == "default":
        yield
        return
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        seen.update(str(w.message).split("\n")[0][:160] for w in caught
                    if "deterministic" in str(w.message))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def flat(grads: dict, names) -> torch.Tensor:
    return torch.cat([grads[n].reshape(-1) for n in names])


def make_model(cs, state=None, remat=False):
    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    cfg = Config()
    cfg.arch.multi_scale, cfg.arch.remat_backbone = True, remat
    model = build_model(cfg.arch, device=DEVICE, train=True)
    if state is None:
        random_init_(model, torch.Generator().manual_seed(1))
    else:
        model.load_state_dict(state)
    return cfg, model


def backbone_part(cs, state, batch, seen):
    """Part 1: the backbone alone, plain / remat / plain."""
    from mvsformer_torch import fp32_math
    from mvsformer_torch.models.mvsformer import remat

    _, model = make_model(cs, state)
    vit = model.vit.train()
    imgs = batch["imgs"][:cs.TRAIN_MICRO]
    x = model.vit_input(imgs.reshape((-1,) + imgs.shape[2:]).permute(0, 3, 1, 2))
    params = [n for n, p in vit.named_parameters() if p.requires_grad]
    out = {}
    for m in MODES:
        runs = []
        for label in ("plain", "remat", "plain again"):
            vit.zero_grad(set_to_none=True)
            gen = torch.Generator(device=DEVICE).manual_seed(7)
            with mode(m, seen), fp32_math():
                feats = (remat(vit, x, gen) if label == "remat"
                         else vit(x, generator=gen))
                ups = [torch.randn(f.shape, generator=torch.Generator(device=DEVICE)
                                   .manual_seed(11 + i), device=DEVICE)
                       for i, f in enumerate(feats)]
                torch.autograd.backward(feats, ups)
            torch.cuda.synchronize()
            grads = dict(vit.named_parameters())
            runs.append({"label": label, "feats": [f.detach().clone() for f in feats],
                         "grad": flat({n: grads[n].grad.detach() for n in params}, params),
                         "gen": gen.get_state()})
        ref = runs[0]
        out[m] = [{"run": r["label"],
                   "outputs_bit_equal": all(torch.equal(a, b)
                                            for a, b in zip(r["feats"], ref["feats"])),
                   "outputs_max_abs": max(float((a - b).abs().max())
                                          for a, b in zip(r["feats"], ref["feats"])),
                   "grad_rel_l2": rel_l2(r["grad"], ref["grad"]),
                   "generator_state_equal": torch.equal(r["gen"], ref["gen"])}
                  for r in runs[1:]]
        del runs, ref
    del model, vit
    torch.cuda.empty_cache()
    return out


def naive_remat(vit, x, generator=None):
    """A wrong `mvsformer.remat`: the backward's second run draws its drop
    path masks on from where the first left the generator."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(lambda x: vit(x, generator=generator), x, use_reentrant=False)


def step_part(cs, state, batch, runs, seen):
    """Part 2: the step's forward and backward, remat off and on in turns."""
    from mvsformer_torch import fp32_math
    from mvsformer_torch.models import mvsformer
    from mvsformer_torch.ops.losses import total_loss
    from mvsformer_torch.train.step import STAGE_KEYS, TrainStep, micro_batches

    out = {}
    for m in MODES:
        res = []
        labels = ["plain", "remat"] * runs + (["naive"] if m == "deterministic" else [])
        for label in labels:
            cfg, model = make_model(cs, state, label != "plain")
            arch = cfg.arch
            step = TrainStep(model, cfg, seed=0)
            micros = micro_batches(batch, cfg.data.multi_scale_args.scale_batch_map)
            losses, depths, after = [], [], []
            with mode(m, seen), fp32_math(), contextlib.ExitStack() as stack:
                if label == "naive":
                    stack.callback(setattr, mvsformer, "remat", mvsformer.remat)
                    mvsformer.remat = naive_remat
                for n, micro in enumerate(micros):
                    dv = micro["depth_values"]
                    o = model(micro["imgs"], micro["proj_matrices"], dv,
                              generator=step.generator(n))
                    loss, _ = total_loss(
                        o, micro["depth_gt"], micro["mask"], dv[:, 1] - dv[:, 0],
                        depth_type=arch.depth_type, focal=arch.focal, gamma=arch.gamma,
                        inverse_depth=arch.inverse_depth, mask_out_range=arch.mask_out_range,
                        stage_keys=STAGE_KEYS[:len(arch.ndepths)])
                    loss.backward()
                    losses.append(float(loss.detach()))
                    depths.append([o[k]["depth"].detach().clone() for k in STAGE_KEYS])
                    after.append({n: p.grad.detach().float().cpu().clone()
                                  for n, p in model.named_parameters() if p.grad is not None})
            res.append({"run": label, "losses": losses, "depths": depths, "grads": after})
            del model, step, o, loss
            torch.cuda.empty_cache()
        ref = res[0]
        names = {g: sorted(n for n in ref["grads"][-1] if n.startswith(g + "."))
                 for g in cs.STEP_GROUPS}
        runs_out = [{"run": r["run"], "losses": r["losses"],
                     "depth_pixels_off_run_0": [[int((a != b).sum()) for a, b in zip(da, db)]
                                                for da, db in zip(r["depths"], ref["depths"])]}
                    for r in res]
        for r in res:
            r["flat"] = [{g: flat(gr, nm) for g, nm in names.items()} for gr in r.pop("grads")]
        pairs = []
        for (i, a), (j, b) in itertools.combinations(enumerate(res), 2):
            pairs.append({"runs": [i, j], "kind": "-".join(sorted((a["run"], b["run"]))), "groups": {
                g: [rel_l2(fa[g], fb[g]) for fa, fb in zip(a["flat"], b["flat"])]
                for g in names}})
        out[m] = {"runs": runs_out, "pairs": pairs}
        del res, ref
    return out


def timing_part(cs, state, batch, steps=4):
    """Part 3: step ms and the allocator's new allocations, plain then remat."""
    from mvsformer_torch.train.step import TrainStep

    out = {}
    for remat in (False, True):
        cfg, model = make_model(cs, state, remat)
        step = TrainStep(model, cfg, seed=0)
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for _ in range(steps):
            torch.cuda.synchronize()
            s0 = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            s1 = torch.cuda.memory_stats()
            rows.append({"ms": ms, "device_allocs": s1["num_device_alloc"] - s0["num_device_alloc"],
                         "alloc_retries": s1["num_alloc_retries"] - s0["num_alloc_retries"],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        out["remat" if remat else "plain"] = rows
        del model, step
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = args.device
    _, model = make_model(cs)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    batch = cs.synthetic_batch(torch, cs.TRAIN_B, cs.TRAIN_V, cs.TRAIN_H, cs.TRAIN_W,
                               device=DEVICE, with_gt=True)
    seen: set = set()
    result = {"card": cs.card_line() if DEVICE == "cuda" else "cpu"}
    for part, fn in (("backbone", lambda: backbone_part(cs, state, batch, seen)),
                     ("step", lambda: step_part(cs, state, batch, args.runs, seen)),
                     ("timing", lambda: timing_part(cs, state, batch))):
        t0 = time.perf_counter()
        result[part] = fn()
        result[part + "_s"] = time.perf_counter() - t0
        print(json.dumps({part: result[part]}), flush=True)
    result["nondeterministic_ops"] = sorted(seen)
    print(json.dumps({"nondeterministic_ops": result["nondeterministic_ops"],
                      "card": result["card"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
