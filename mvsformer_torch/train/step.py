"""One training step of TwinMVSNet or DINOMVSNet on one device.

Port of the single-device part of `mvsformer_tpu/parallel/train_step.py`
(`make_grad_step`, `make_apply_step`) and of the step loop of
`mvsformer_tpu/train/trainer.py` (`micro_batches`, `train_epoch`):

- the batch is split into micro-batches of `scale_batch_map[height]`
  samples (the reference's resolution-dependent accumulation);
- each micro-batch runs the training forward, `total_loss` and the
  backward, with its own drop-path generator, seeded from (seed, step,
  micro-batch) as the JAX trainer folds (step, micro-batch) into its key;
- BN running statistics chain from one micro-batch to the next, since each
  training forward updates them in place;
- the gradients are summed over the micro-batches and divided by their
  number, then one AdamW step and one schedule step follow.

Forward and backward run with TF32 off (`fp32_math`), so the fp32 work
runs in full fp32 on the card. The batch takes the parameters' dtype, so a
float64 model (the CPU parity test's) runs the step in float64 around the
same fp32 parts as the JAX model: the warp and correlation, the softmaxes
and the losses. A bf16 model (`build_model(..., dtype=torch.bfloat16)`)
casts the images to bf16 in its forward and keeps the JAX package's fp32
islands; its outputs, the losses and the backward's gradients reach the
fp32 parameters in fp32, and AdamW's state stays fp32. There is no loss
scaler: bf16 has fp32's exponent range.
`train/trainer.py` drives it over the data loader's batches; the batch is
a dict of tensors or arrays in the JAX layout:
imgs [B, V, H, W, 3], proj_matrices {stageK: [B, V, 2, 4, 4]},
depth_values [B, Dfull], depth_gt and mask {stageK: [B, h, w]}.
"""

from __future__ import annotations

import torch

from mvsformer_torch import fp32_math
from mvsformer_torch.config import Config
from mvsformer_torch.ops.losses import total_loss
from mvsformer_torch.train.optim import build_optimizer

STAGE_KEYS = ("stage1", "stage2", "stage3", "stage4")


def _map(batch, fn):
    return {k: ({s: fn(t) for s, t in v.items()} if isinstance(v, dict) else fn(v))
            for k, v in batch.items()}


def micro_batches(batch: dict, scale_batch_map) -> list[dict]:
    """Split along the batch axis into micro-batches of
    `scale_batch_map[str(height)]` samples (the whole batch for a height the
    map does not name), shrunk until it divides the batch."""
    B, h = batch["imgs"].shape[0], batch["imgs"].shape[2]
    sizes = {int(k): int(v) for k, v in scale_batch_map.items()}
    mb = max(1, min(sizes.get(h, B), B))
    while B % mb:
        mb -= 1
    return [_map(batch, lambda t, i=i: t[i * mb:(i + 1) * mb]) for i in range(B // mb)]


def _clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm: g * max_norm / norm where norm > max_norm."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class TrainStep:
    """Holds the model, its AdamW and schedule, and the step count.

    `total_steps` is the schedule's length: the JAX trainer's
    `epochs * steps_per_epoch`, so by default `cfg.trainer.epochs *
    steps_per_epoch`.
    """

    def __init__(self, model, cfg: Config, steps_per_epoch: int = 1, seed: int = 0):
        self.model = model
        self.cfg = cfg
        self.seed = seed
        self.total_steps = max(1, steps_per_epoch) * cfg.trainer.epochs
        self.optimizer, self.scheduler = build_optimizer(
            model, cfg.optimizer, self.total_steps, fix=cfg.arch.fix,
            model_type=cfg.arch.model_type)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.global_step = 0

    def generator(self, micro: int) -> torch.Generator:
        device = next(self.model.parameters()).device
        seed = (self.seed * (1 << 40) + self.global_step * (1 << 20) + micro) % (1 << 63)
        return torch.Generator(device=device).manual_seed(seed)

    def __call__(self, batch: dict) -> dict:
        """One optimizer step on `batch`. Returns the step's metrics: the
        loss and each stage's loss (means over the micro-batches), the
        global norm of the averaged gradient before any clip, and the base
        LR this step applied (the `lr` group's)."""
        model, arch = self.model, self.cfg.arch
        param = next(model.parameters())
        model.train()
        batch = _map(batch, lambda t: torch.as_tensor(t, dtype=param.dtype, device=param.device))
        micros = micro_batches(batch, self.cfg.data.multi_scale_args.scale_batch_map)
        stage_keys = STAGE_KEYS[:len(arch.ndepths)]
        self.optimizer.zero_grad(set_to_none=True)
        sums = {k: 0.0 for k in ("loss",) + stage_keys}
        with fp32_math():
            for n, micro in enumerate(micros):
                dv = micro["depth_values"]
                out = model(micro["imgs"], micro["proj_matrices"], dv,
                            generator=self.generator(n))
                loss, stage_losses = total_loss(
                    out, micro["depth_gt"], micro["mask"], dv[:, 1] - dv[:, 0],
                    depth_type=arch.depth_type, focal=arch.focal, gamma=arch.gamma,
                    inverse_depth=arch.inverse_depth, mask_out_range=arch.mask_out_range,
                    stage_keys=stage_keys)
                loss.backward()
                sums["loss"] += float(loss.detach())
                for k in stage_keys:
                    sums[k] += float(stage_losses[k].detach())
            grads = [p.grad for p in self.params if p.grad is not None]
            if len(micros) > 1:
                for g in grads:
                    g.div_(len(micros))
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if self.cfg.optimizer.grad_norm is not None:
                _clip_by_global_norm(grads, self.cfg.optimizer.grad_norm, norm)
            lr = next(g["lr"] for g in self.optimizer.param_groups if g["group"] == "rest")
            self.optimizer.step()
        self.scheduler.step()
        self.global_step += 1
        metrics = {("loss" if k == "loss" else f"loss_{k}"): v / len(micros)
                   for k, v in sums.items()}
        metrics.update(grad_norm=float(norm), lr=lr, micro_batches=len(micros))
        return metrics
