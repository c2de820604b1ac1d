"""Convert a JAX training run's orbax checkpoints into the PyTorch port's.

    python tools/orbax_to_torch.py RUN_DIR OUT_DIR

RUN_DIR is a run directory of the JAX package's `train.py`
(`saved/models/<name>/`): its `config.json` and the orbax directories
`model_best`, `model_last` and `model_step` that are there, each with its
`.meta.json`. OUT_DIR receives, for each of them, `<name>.pth` and
`<name>.meta.json` in the layout `mvsformer_torch/train/checkpoint.py`
writes, and `config.json`. `python -m mvsformer_torch.test --ckpt_dir
OUT_DIR` serves them; `python -m mvsformer_torch.train --config
OUT_DIR/config.json --resume` continues the run (the config's
`trainer.save_dir` and `name` are set so that OUT_DIR is its run dir when
OUT_DIR is `<save_dir>/models/<name>`), and `--finetune OUT_DIR` starts
another run from it.

This script needs JAX, orbax and the JAX package: run it where they are
installed. Nothing in `mvsformer_torch/` imports it, so the port runs
without them.

Each checkpoint is restored without a template (the JAX
`CheckpointManager.restore`, mvsformer_tpu/train/checkpoint.py:72-100), so
a run saved on any mesh converts on one CPU. Then:

- `params` and `batch_stats` become the port's `state_dict` through the
  port's weight bridge (`convert_flax`), loaded strictly into the model
  `build_model` builds from the same config: every tensor of every
  `ModelConfig` variant is accounted for.
- `opt_state`, the optax chain of `make_optimizer`
  (mvsformer_tpu/train/optim.py:129-165), becomes the state of the AdamW
  that the port's `build_optimizer` builds from the same config, in its
  groups and order: Adam's `mu` and `nu` map through the same layout
  transforms as the weights (a transpose or a flip, applied to each
  moment elementwise) to each parameter's `exp_avg` and `exp_avg_sq`, and
  the Adam count to its `step`. Under `fix` the backbone's moments (zeros:
  it takes no gradient) are dropped, as the port leaves the backbone out
  of its optimizer. The clip, the decayed weights, the per-leaf LR scale
  and the frozen mask hold no state; the schedule's count must equal
  Adam's and the meta's `global_step`, which the port's resume reads
  (`set_step`), so the first step after a resume applies the LR the JAX
  step would.
- A checkpoint without `opt_state` (a params-only export, which the JAX
  `Trainer.finetune(restore_opt=False)` takes) gives a `.pth` without
  `optimizer`: the port's `finetune(restore_opt=False)` takes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NAMES = ("model_best", "model_last", "model_step")


def optax_states(tree) -> tuple:
    """(Adam's {count, mu, nu}, the schedule's {count}) in a template-free
    restore of the optax chain (namedtuples come back as dicts of their
    fields)."""
    adam, schedules = [], []

    def walk(x):
        if isinstance(x, dict):
            if {"count", "mu", "nu"} <= set(x):
                adam.append(x)
                return
            if set(x) == {"count"}:
                schedules.append(x)
                return
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    if len(adam) != 1 or len(schedules) != 1:
        raise ValueError(f"the optimizer state holds {len(adam)} Adam states and "
                         f"{len(schedules)} schedule counts, not one of each: not the chain "
                         f"mvsformer_tpu/train/optim.py make_optimizer builds")
    return adam[0], schedules[0]


def port_config(run_dir: str, out_dir: str):
    """The run's config as the port reads it, with `trainer.save_dir` and
    `name` pointing at OUT_DIR where OUT_DIR is `<save_dir>/models/<name>`."""
    from mvsformer_torch.config import load_config

    cfg = load_config(os.path.join(run_dir, "config.json"))
    parent = os.path.dirname(os.path.abspath(out_dir))
    if os.path.basename(parent) == "models":
        cfg.trainer.save_dir = os.path.dirname(parent)
        cfg.name = os.path.basename(os.path.abspath(out_dir))
    return cfg


def convert_state(full: dict, meta: dict, cfg) -> dict:
    """One restored orbax checkpoint ({params, batch_stats[, opt_state]})
    -> the port's checkpoint dict (without epoch and monitor_best, which
    the port's manager adds from the meta)."""
    import torch

    from mvsformer_torch.models.mvsformer import build_model
    from mvsformer_torch.train.optim import build_optimizer, set_step
    from mvsformer_torch.utils.convert_weights import BUFFER_SUFFIXES, convert_flax

    arch = cfg.arch
    model = build_model(arch, device="cpu", train=True)
    vit_depths = (tuple(len(b) for b in model.vit.blocks) if arch.model_type == "twin"
                  else None)
    kw = dict(ndepths=tuple(arch.ndepths), model_th=arch.model_th)
    if vit_depths is not None:
        kw["vit_depths"] = vit_depths

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return np.asarray(tree)

    params, stats = to_numpy(full["params"]), to_numpy(full.get("batch_stats") or {})
    model.load_state_dict(convert_flax(params, stats, **kw), strict=True)
    state = {"arch": type(model).__name__, "state_dict": model.state_dict(),
             "config": dataclasses.asdict(cfg)}
    if "opt_state" not in full:
        state["global_step"] = int(meta.get("global_step", 0))
        return state

    adam, schedule = optax_states(full["opt_state"])
    count, sched_count = int(np.asarray(adam["count"])), int(np.asarray(schedule["count"]))
    global_step = int(meta.get("global_step", count))
    if not count == sched_count == global_step:
        raise ValueError(f"Adam's count {count}, the schedule's {sched_count} and the meta's "
                         f"global_step {global_step} differ: the port resumes at one step "
                         f"count for all three")

    def moments(tree):
        sd = convert_flax(to_numpy(tree), stats, **kw)
        return {k: v for k, v in sd.items() if not k.endswith(BUFFER_SUFFIXES)}

    mu, nu = moments(adam["mu"]), moments(adam["nu"])
    epochs = max(1, cfg.trainer.epochs)
    optimizer, scheduler = build_optimizer(model, cfg.optimizer, epochs, fix=arch.fix,
                                           model_type=arch.model_type)
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = names[p]
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": mu[n].to(p.dtype).clone(),
                                  "exp_avg_sq": nu[n].to(p.dtype).clone()}
    set_step(optimizer, scheduler, count)
    state.update(optimizer=optimizer.state_dict(), scheduler=scheduler.state_dict(),
                 global_step=global_step)
    return state


def convert_run(run_dir: str, out_dir: str, log=print) -> list:
    """Convert every orbax checkpoint of NAMES present in `run_dir` into
    `out_dir`; returns the names converted."""
    from mvsformer_tpu.train.checkpoint import CheckpointManager as OrbaxManager
    from mvsformer_torch.train.checkpoint import CheckpointManager

    run_dir, out_dir = os.path.abspath(run_dir), os.path.abspath(out_dir)
    if run_dir == out_dir:
        raise ValueError("OUT_DIR must not be RUN_DIR")
    cfg = port_config(run_dir, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    shutil.copyfile(os.path.join(run_dir, "config.json"), os.path.join(out_dir, "config.json"))
    _set_run_dir(os.path.join(out_dir, "config.json"), cfg)
    src = OrbaxManager(run_dir, cfg.trainer.monitor)
    dst = CheckpointManager(out_dir, cfg.trainer.monitor)
    done = []
    for name in NAMES:
        if not src.has(name):
            continue
        full, meta = src.restore(name)
        state = convert_state(full, meta, cfg)
        dst._save(name, state, meta)
        log(f"{name}: {state['arch']}, {len(state['state_dict'])} tensors, "
            + (f"optimizer at step {state['global_step']}" if "optimizer" in state
               else "no optimizer state") + f" -> {dst.path(name)}")
        done.append(name)
    if not done:
        raise FileNotFoundError(f"no orbax checkpoint of {list(NAMES)} in {run_dir}")
    return done


def _set_run_dir(path: str, cfg) -> None:
    """Write the port config's save_dir and name into the copied JSON,
    leaving the rest of the JAX run's config as it was."""
    with open(path) as f:
        raw = json.load(f)
    raw["name"] = cfg.name
    raw.setdefault("trainer", {})["save_dir"] = cfg.trainer.save_dir
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_dir", help="the JAX run directory (config.json, model_* dirs)")
    parser.add_argument("out_dir", help="where the port's checkpoints go")
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    convert_run(args.run_dir, args.out_dir)


if __name__ == "__main__":
    main()
