"""AdamW with the backbone/cascade LR split, DINO's layer decay, and the
warmup-cosine schedule.

Port of `mvsformer_tpu/train/optim.py`. The optax chain there (clip, Adam,
decoupled weight decay, learning rate, per-leaf LR scale, frozen mask) is
torch's AdamW over parameter groups:

- `vit.*` tensors of ndim > 1 outside `pos_embed` / `cls_token`: the
  backbone's LR and weight decay;
- the backbone's other tensors: its LR, no decay;
- everything else: `lr`, no decay.

The backbone's LR is `vit_lr` for Twins. For the DINO ViT (`model_type`
"dino") it decays by layer, as BEiT's: a tensor's layer id is 0 for
`cls_token`, `pos_embed` and `patch_embed`, i + 1 for block i and depth + 1
for the rest (the final norm), and its LR is `vit_lr * layer_decay^(depth
+ 1 - id)`; each (layer id, decay) pair is a group.

optax adds `weight_decay * p` to the Adam direction before the LR scales
both, so the decay runs at the group's LR, which is what AdamW does. The
schedule is a `LambdaLR` that multiplies every group's base LR by the same
warmup-cosine factor; step k of the optimizer uses factor(k), as optax's
count does. With `fix` the backbone's tensors are left out of the optimizer
(and take no gradient).

`set_step` puts AdamW and its schedule at a step count together, as the JAX
trainer sets every optax `count`; `warmup_multistep_schedule` is the JAX
package's secondary schedule (linear or constant warmup, then step decay).
"""

from __future__ import annotations

import math

import torch


def warmup_cosine_factor(step: int, warmup_steps: int, total_steps: int,
                         min_lr_frac: float) -> float:
    """LR multiplier at `step`: linear 0 -> 1 over the warmup, then a cosine
    from 1 to `min_lr_frac` at `total_steps`."""
    if step < warmup_steps:
        return step / max(1, warmup_steps)
    prog = (step - warmup_steps) / max(1, total_steps - warmup_steps)
    return min_lr_frac + (1.0 - min_lr_frac) * 0.5 * (1.0 + math.cos(math.pi * prog))


def warmup_multistep_schedule(base_lr: float, milestones, gamma: float = 0.1,
                              warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                              warmup_method: str = "linear"):
    """lr(step): the warmup factor (constant, or linear from warmup_factor
    to 1) before warmup_iters, times gamma for every milestone reached."""
    milestones = tuple(sorted(milestones))

    def fn(step):
        if step < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = step / max(1, warmup_iters)
                wf = warmup_factor * (1 - alpha) + alpha
        else:
            wf = 1.0
        return base_lr * wf * gamma ** sum(step >= m for m in milestones)

    return fn


def set_step(optimizer: torch.optim.Optimizer, scheduler, step: int) -> None:
    """Put AdamW and its LambdaLR at step count `step`, so the next update
    applies the schedule's factor at `step` and Adam's bias correction for
    update `step + 1`: every parameter's `step` is set (a parameter with no
    state yet gets zero moments), the scheduler's position too, and each
    group's LR follows. Moments already there are kept."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["step"].fill_(float(step))
    scheduler.last_epoch = step
    for group, base, factor in zip(optimizer.param_groups, scheduler.base_lrs,
                                   scheduler.lr_lambdas):
        group["lr"] = base * factor(step)
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether weight decay applies (optim.py weight_decay_mask)."""
    return (name.startswith("vit.") and param.dim() > 1
            and "pos_embed" not in name and "cls_token" not in name)


def vit_layer_id(name: str, depth: int) -> int:
    """The BEiT layer id of a DINO ViT tensor `vit.*` (optim.py
    _vit_layer_id): 0 for the embeddings, i + 1 for block i, depth + 1 for
    the rest."""
    rest = name[len("vit."):]
    if rest.startswith(("cls_token", "pos_embed", "patch_embed")):
        return 0
    if rest.startswith("blocks."):
        return int(rest.split(".")[1]) + 1
    return depth + 1


def _group_of(name: str, param: torch.Tensor, opt_cfg, depth) -> tuple:
    """(group, LR, weight decay) of a parameter; `depth` is the DINO ViT's
    block count (layer decay), None for Twins."""
    if not name.startswith("vit."):
        return "rest", opt_cfg.lr, 0.0
    group, wd = (("vit_decay", opt_cfg.weight_decay) if decays(name, param)
                 else ("vit_no_decay", 0.0))
    if depth is None:
        return group, opt_cfg.vit_lr, wd
    lid = vit_layer_id(name, depth)
    return f"{group}_layer{lid}", opt_cfg.vit_lr * opt_cfg.layer_decay ** (depth + 1 - lid), wd


def param_groups(model: torch.nn.Module, opt_cfg, fix: bool = False,
                 model_type: str = "twin") -> list[dict]:
    """The AdamW groups, each with its names for reference: the backbone's
    in the order their first tensors come, then `rest`."""
    depth = len(model.vit.blocks) if model_type == "dino" else None
    groups: dict = {}
    for name, p in model.named_parameters():
        if fix and name.startswith("vit."):
            continue
        key, lr, wd = _group_of(name, p, opt_cfg, depth)
        group = groups.setdefault(key, {"params": [], "names": [], "lr": lr,
                                        "weight_decay": wd, "group": key})
        group["params"].append(p)
        group["names"].append(name)
    return sorted(groups.values(), key=lambda g: g["group"] == "rest")


def build_optimizer(model: torch.nn.Module, opt_cfg, total_steps: int, fix: bool = False,
                    model_type: str = "twin"):
    """-> (AdamW, LambdaLR). With `fix` the backbone's parameters stop
    requiring gradients and are not in the optimizer."""
    if fix:
        for p in model.vit.parameters():
            p.requires_grad_(False)
    optimizer = torch.optim.AdamW(param_groups(model, opt_cfg, fix, model_type),
                                  betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: warmup_cosine_factor(step, opt_cfg.warmup_steps, total_steps,
                                                     opt_cfg.min_lr))
    return optimizer, scheduler
