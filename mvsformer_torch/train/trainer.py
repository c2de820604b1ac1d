"""Training orchestration: the epoch loop, validation, checkpoints, resume.

Port of `mvsformer_tpu/train/trainer.py` on one device, over
`train/step.py`'s `TrainStep` (micro-batches by `scale_batch_map`, the
training forward and loss, the backward, AdamW and the schedule):

- `init_state` builds the optimizer and, with `arch.vit_args.vit_path`,
  merges a pretrained backbone (Twins or DINO's ViT); `state_dict`,
  `restore`,
  `resume_auto` (the furthest of `model_last` and the mid-epoch
  `model_step`) and `finetune` (another run's checkpoint, with or without
  its Adam moments, its schedule reset or fast-forwarded) as the JAX
  trainer has them.
- `train_epoch` runs the loader's batches from `skip_batches` on, writes
  `model_step` every `save_every_steps` steps, scans each top-level
  module's gradient for non-finite values with `debug`, and traces the
  step window [start, start + steps) with `torch.profiler` when given a
  `profile`, writing its Chrome trace (`trace.json`) and its device idle share
  (`profile_summary.json`).
- `valid_epoch` runs the eval forward (the model in eval mode, under
  `no_grad`; the forward turns TF32 off itself), so validation is the
  path K1-K6 serve, and averages the validation metrics: DTU's threshold
  unit is the batch's first depth interval / 2.65, BlendedMVS's each
  sample's own interval. A trailing partial batch runs as it is (each
  process runs its own; the JAX trainer pads it to its data axis).
- `train` alternates them, checkpointing on `trainer.monitor`, every
  `eval_freq` epochs, and stops after `early_stop` validations without
  improvement.

As one rank of the model's layout (`parallel/mesh.py`; the CLI gives each
data rank its share of every batch, per-device micro-batches of
`scale_batch_map[height]`, as the JAX trainer's host micro-batch of map x
data splits over its data axis): the step averages over the world
(`TrainStep`); the validation metrics are averaged over the processes
whenever a process group is running (the reference's all_reduce / world,
`mvsformer_trainer.py:202-212`), so every rank takes the same
checkpoint and early-stop decisions; only rank 0 writes checkpoints, the
log, `train_log.jsonl` and the profile; a resume or finetune waits at a
barrier before it reads a checkpoint.

The TensorBoard writer is optional (`writer=None` writes no scalar or
image). Whatever the writer, every step, epoch, validation, checkpoint and
profile appends one JSON record to `<run dir>/train_log.jsonl`: the
losses, the LR, host ms, the ms spent waiting on the loader, the crop size,
the micro-batch count, the kernel launches (`ops/cuda_build.LAUNCHES`
deltas), checkpoint ms and bytes, and peak device memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mvsformer_torch.config import Config
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.train.checkpoint import CheckpointManager
from mvsformer_torch.train.meters import DictAverageMeter
from mvsformer_torch.train.optim import set_step
from mvsformer_torch.train.step import STAGE_KEYS, TrainStep
from mvsformer_torch.utils import metrics as metric_lib

EVAL_TMPS = (5.0, 5.0, 5.0, 1.0)  # the eval forward's stage temperatures


class _PrintLogger:
    def info(self, msg):
        print(msg, flush=True)


class _QuietLogger:
    def info(self, msg):
        pass


def _barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _launches_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in cuda_build.LAUNCHES.items()
            if v - before.get(k, 0)}


def _peak_gb(device) -> float | None:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _norm_img(x):
    """First sample, percentile-normalised, as a [1, H, W] image."""
    x = np.asarray(x[0], np.float32)
    lo, hi = np.percentile(x, 2), np.percentile(x, 98)
    return np.clip((x - lo) / max(hi - lo, 1e-6), 0, 1)[None]


def validation_scalars(depth_est, depth_gt, mask, depth_values, is_blended: bool) -> dict:
    """One validation batch's metrics (floats): DTU's at di = the first
    sample's depth interval / 2.65, BlendedMVS's per sample at its own
    interval, then averaged over the batch."""
    itv = depth_values[:, 1] - depth_values[:, 0]
    if not is_blended:
        di = float(itv[0]) / 2.65
        return {k: float(v) for k, v in
                metric_lib.validation_metrics(depth_est, depth_gt, mask, di).items()}
    scalars: dict = {}
    B = depth_est.shape[0]
    for j in range(B):
        m = metric_lib.validation_metrics(depth_est[j:j + 1], depth_gt[j:j + 1],
                                          mask[j:j + 1], float(itv[j]))
        for k, v in m.items():
            scalars[k] = scalars.get(k, 0.0) + float(v) / B
    return scalars


class Trainer:
    """Trains `model` on `train_loader`'s batches; without a model it builds
    the model of `cfg.arch` (TwinMVSNet or DINOMVSNet) on `device` (`cuda`
    unless the caller asks for the CPU). `profile` is (dir, start step,
    number of steps)."""

    def __init__(self, cfg: Config, train_loader, val_loader=None, model=None, device=None,
                 writer=None, logger=None, is_blended=False, debug=False, profile=None, seed=0):
        from mvsformer_torch.models.mvsformer import build_model

        self.cfg = cfg
        self.model = model if model is not None else build_model(cfg.arch, device=device,
                                                                 train=True)
        self.device = next(self.model.parameters()).device
        self.layout = getattr(self.model, "layout", None)
        self.writes = self.layout is None or self.layout.rank == 0
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.writer = writer
        self.logger = logger or (_PrintLogger() if self.writes else _QuietLogger())
        self.is_blended = is_blended
        self.debug = debug
        self.profile = profile
        self._profiler = None
        self._profiled = False
        self._profile_t0 = (0, 0.0)
        self.seed = seed
        self.save_every_steps = cfg.trainer.save_every_steps
        self.run_dir = os.path.join(cfg.trainer.save_dir, "models", cfg.name)
        self.ckpt = CheckpointManager(self.run_dir, cfg.trainer.monitor, cfg.trainer.save_period,
                                      write=self.writes)
        self.log_path = os.path.join(self.run_dir, "train_log.jsonl")
        self.step = None
        self._not_improved = 0

    # -- state ---------------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self.step.global_step

    @global_step.setter
    def global_step(self, value: int):
        self.step.global_step = int(value)

    @property
    def optimizer(self):
        return self.step.optimizer

    @property
    def scheduler(self):
        return self.step.scheduler

    def schedule(self, step: int) -> float:
        """The base LR (the `lr` group's) the schedule gives at `step`."""
        group = next(i for i, g in enumerate(self.optimizer.param_groups) if g["group"] == "rest")
        return self.scheduler.base_lrs[group] * self.scheduler.lr_lambdas[group](step)

    def init_state(self):
        """Merge the pretrained backbone (`arch.vit_args.vit_path`), then
        build AdamW and its schedule over `epochs * len(train_loader)`
        steps."""
        if self.cfg.arch.vit_args.vit_path:
            from mvsformer_torch.utils.convert_weights import merge_pretrained_backbone

            merge_pretrained_backbone(self.model, self.cfg.arch.vit_args.vit_path,
                                      log=self.logger.info)
        self.step = TrainStep(self.model, self.cfg, steps_per_epoch=len(self.train_loader),
                              seed=self.seed)

    def state_dict(self) -> dict:
        return {"arch": type(self.model).__name__, "state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "config": dataclasses.asdict(self.cfg), "global_step": self.global_step}

    def restore(self, name="model_last") -> dict:
        """Load this run's checkpoint `name`: the model, Adam's moments and
        the step count. The LR follows this run's schedule from that count
        on, as the JAX trainer's restored optax counts do (a resumed run
        with more epochs has a longer schedule than the run that saved)."""
        state, meta = self.ckpt.restore(name)
        self.model.load_state_dict(state["state_dict"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(meta.get("global_step", self.global_step))
        set_step(self.optimizer, self.scheduler, self.global_step)
        return meta

    def resume_auto(self):
        """Restore the furthest checkpoint: `model_step` (mid-epoch) when its
        global_step is ahead of `model_last`'s. Returns {"start_epoch",
        "skip_batches"}, or None without a checkpoint."""
        _barrier()
        best_name, best_meta = None, {}
        for name in ("model_last", "model_step"):
            if self.ckpt.has(name):
                meta = self.ckpt.peek_meta(name)
                if (best_name is None
                        or meta.get("global_step", 0) > best_meta.get("global_step", 0)):
                    best_name, best_meta = name, meta
        if best_name is None:
            return None
        meta = self.restore(best_name)
        if best_name == "model_step":
            out = {"start_epoch": int(meta.get("epoch", 1)),
                   "skip_batches": int(meta.get("batch_idx", -1)) + 1}
        else:
            out = {"start_epoch": int(meta.get("epoch", 0)) + 1, "skip_batches": 0}
        self.logger.info(
            f"resumed {best_name} (epoch {meta.get('epoch')}, global_step "
            f"{self.global_step}) -> start_epoch {out['start_epoch']}, "
            f"skip {out['skip_batches']} batches")
        self._record(kind="resume", name=best_name, global_step=self.global_step, **out)
        return out

    def finetune(self, ckpt_dir: str, name: str = "model_best", restore_opt: bool = True,
                 reset_schedule: bool = True) -> dict:
        """Load another run's checkpoint: the model always; Adam's moments
        with `restore_opt`; the step count (schedule and bias correction)
        reset to 0 with `reset_schedule`, else fast-forwarded to the
        checkpoint's global_step."""
        _barrier()
        mgr = CheckpointManager(ckpt_dir, self.cfg.trainer.monitor, write=False)
        state, meta = mgr.restore(name)
        self.model.load_state_dict(state["state_dict"])
        saved_step = int(meta.get("global_step", 0))
        if restore_opt:
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            self.step = TrainStep(self.model, self.cfg, steps_per_epoch=len(self.train_loader),
                                  seed=self.seed)
        if restore_opt or not reset_schedule:
            set_step(self.optimizer, self.scheduler, 0 if reset_schedule else saved_step)
        self.global_step = 0 if reset_schedule else saved_step
        self.logger.info(
            f"finetune: restored {name} from {ckpt_dir} (epoch {meta.get('epoch')}, "
            f"restore_opt={restore_opt}, reset_schedule={reset_schedule}, "
            f"global_step={self.global_step})")
        return meta

    # -- records -------------------------------------------------------------

    def _record(self, **rec):
        if not self.writes:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _record_saves(self):
        while self.ckpt.saves:
            self._record(kind="checkpoint", global_step=self.global_step,
                         **self.ckpt.saves.pop(0))

    def _profile_tick(self):
        """Open the profile window at its first step; close it once it holds
        its steps, writing the Chrome trace and the device idle share."""
        if self.profile is None or not self.writes:
            return
        pdir, pstart, psteps = self.profile
        if self._profiler is None and not self._profiled and self.global_step >= pstart:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
            self._profile_t0 = (self.global_step, time.perf_counter())
        elif self._profiler is not None and self.global_step >= self._profile_t0[0] + psteps:
            self._profile_stop()

    def _profile_stop(self):
        pdir, _, _ = self.profile
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self._profile_t0[1]) * 1e3
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        self._profiled = True
        os.makedirs(pdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(pdir, "trace.json"))
        # The raw events: building the profiler's event tree (`prof.events()`)
        # takes minutes for a window of full-size training steps.
        kernel_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
        summary = {"steps": self.global_step - self._profile_t0[0],
                   "first_step": self._profile_t0[0], "wall_ms": wall_ms,
                   "kernel_ms": kernel_ms if self.device.type == "cuda" else None}
        summary["idle_share"] = (max(0.0, 1 - kernel_ms / wall_ms)
                                 if self.device.type == "cuda" and kernel_ms else None)
        with open(os.path.join(pdir, "profile_summary.json"), "w") as f:
            json.dump(summary, f)
        self._record(kind="profile", dir=pdir, **summary)
        self.logger.info(f"profiler trace written to {pdir}: {summary}")

    # -- loops ---------------------------------------------------------------

    def _stages(self):
        return STAGE_KEYS[:len(self.cfg.arch.ndepths)]

    def _train_batch(self, batch):
        stages = self._stages()
        return {"imgs": batch["imgs"],
                "proj_matrices": {k: batch["proj_matrices"][k] for k in stages},
                "depth_values": batch["depth_values"],
                "depth_gt": {k: batch["depth"][k] for k in stages},
                "mask": {k: batch["mask"][k] for k in stages}}

    def train_epoch(self, epoch: int, skip_batches: int = 0) -> dict:
        self.train_loader.set_epoch(epoch)
        meter = DictAverageMeter()
        _reset_peak(self.device)
        t_epoch = time.perf_counter()
        t_wait = time.perf_counter()
        n_batches = len(self.train_loader)
        for batch_idx, batch in enumerate(self.train_loader):
            wait_ms = (time.perf_counter() - t_wait) * 1e3
            if batch_idx < skip_batches:
                t_wait = time.perf_counter()
                continue  # mid-epoch resume: the seeded loader order makes skipping exact
            self._profile_tick()
            t0 = time.perf_counter()
            before = dict(cuda_build.LAUNCHES)
            metrics = self.step(self._train_batch(batch))
            step_ms = (time.perf_counter() - t0) * 1e3
            if self.debug:
                for name, module in self.model.named_children():
                    grads = [p.grad.abs().max() for p in module.parameters() if p.grad is not None]
                    if not grads:
                        continue
                    gmax = float(torch.stack(grads).max())
                    if not np.isfinite(gmax):
                        self.logger.info(f"NONFINITE grad in '{name}' at step {self.global_step}")
                    if self.writer is not None:
                        self.writer.add_scalar(f"grads/{name}_max", gmax, self.global_step)
            if self.save_every_steps and self.global_step % self.save_every_steps == 0:
                self.ckpt._save("model_step", self.state_dict(), {
                    "epoch": epoch, "batch_idx": batch_idx, "global_step": self.global_step,
                    "monitor_best": float(self.ckpt.best)})
                self._record_saves()
            logs = {k: v for k, v in metrics.items() if k.startswith("loss")}
            logs["grad_norm"] = metrics["grad_norm"]
            meter.update(logs)
            h, w = batch["imgs"].shape[2:4]
            self._record(kind="step", epoch=epoch, batch_idx=batch_idx,
                         global_step=self.global_step, lr=metrics["lr"], ms=step_ms,
                         wait_ms=wait_ms, crop=[int(h), int(w)],
                         micro_batches=metrics["micro_batches"],
                         launches=_launches_since(before), **logs)
            if batch_idx % self.cfg.trainer.logging_every == 0:
                self.logger.info(
                    f"epoch {epoch} [{batch_idx}/{n_batches}] loss={logs['loss']:.4f} "
                    f"lr={self.schedule(self.global_step):.2e} time={step_ms / 1e3:.2f}s "
                    f"crop={h}x{w} micro={metrics['micro_batches']} wait={wait_ms:.0f}ms")
                if self.writer is not None:
                    for k, v in logs.items():
                        self.writer.add_scalar(f"train/{k}", v, self.global_step)
                    self.writer.add_scalar("train/lr", self.schedule(self.global_step),
                                           self.global_step)
            t_wait = time.perf_counter()
        if self._profiler is not None:
            self._profile_stop()
        out = meter.mean()
        out["epoch_time"] = time.perf_counter() - t_epoch
        load_ms = list(self.train_loader.load_ms)
        self._record(kind="train_epoch", epoch=epoch, peak_memory_gb=_peak_gb(self.device),
                     load_ms_per_sample=sum(load_ms) / max(1, len(load_ms)),
                     samples_loaded=len(load_ms), **out)
        return out

    def _eval_forward(self, batch):
        """(refined depth, confidence) of the eval forward on a loader batch
        (this view rank's source views of it)."""
        stages = self._stages()

        def dev(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        imgs, projs = dev(batch["imgs"]), {k: dev(batch["proj_matrices"][k]) for k in stages}
        if self.layout is not None:
            imgs, projs = self.layout.local_request(imgs, projs)
        with torch.no_grad():
            out = self.model(imgs, projs, dev(batch["depth_values"]), tmp=list(EVAL_TMPS))
        return out["refined_depth"], out["photometric_confidence"]

    def valid_epoch(self, epoch: int) -> dict:
        meter = DictAverageMeter()
        was_training = self.model.training
        self.model.eval()
        _reset_peak(self.device)
        before = dict(cuda_build.LAUNCHES)
        batch_ms = []
        try:
            for batch in self.val_loader:
                t0 = time.perf_counter()
                depth_est, conf = self._eval_forward(batch)
                depth_gt = torch.as_tensor(batch["depth"]["stage4"], device=depth_est.device)
                mask = torch.as_tensor(batch["mask"]["stage4"], device=depth_est.device) > 0.5
                dv = torch.as_tensor(batch["depth_values"], device=depth_est.device)
                meter.update(validation_scalars(depth_est, depth_gt, mask, dv, self.is_blended))
                batch_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            self.model.train(was_training)
        out = meter.mean()
        if dist.is_available() and dist.is_initialized():
            keys = sorted(out)
            vals = torch.tensor([out[k] for k in keys], dtype=torch.float64, device=self.device)
            dist.all_reduce(vals)
            out = dict(zip(keys, (vals / dist.get_world_size()).tolist()))
        out["mean_error"] = (out["thres2mm_error"] + out["thres4mm_error"]
                             + out["thres8mm_error"] + out["thres14mm_error"]) / 4.0
        load_ms = list(getattr(self.val_loader, "load_ms", []))
        self._record(kind="val", epoch=epoch, batch_ms=batch_ms,
                     peak_memory_gb=_peak_gb(self.device), launches=_launches_since(before),
                     load_ms_per_sample=sum(load_ms) / max(1, len(load_ms)), **out)
        if self.writer is not None:
            for k, v in out.items():
                self.writer.add_scalar(f"val/{k}", v, epoch)
            depth_np = depth_est.cpu().numpy()
            self.writer.add_image("val/pred_depth", _norm_img(depth_np * mask.cpu().numpy()),
                                  epoch)
            self.writer.add_image("val/gt_depth", _norm_img(depth_gt.cpu().numpy()), epoch)
            self.writer.add_image("val/confidence", _norm_img(conf.cpu().numpy()), epoch)
        return out

    def train(self, start_epoch: int = 1, skip_batches: int = 0):
        history = []
        for epoch in range(start_epoch, self.cfg.trainer.epochs + 1):
            train_log = self.train_epoch(epoch, skip_batches if epoch == start_epoch else 0)
            self.logger.info(f"epoch {epoch} train: {train_log}")
            log = dict(train_log)
            if self.val_loader is not None and epoch % self.cfg.trainer.eval_freq == 0:
                val_log = self.valid_epoch(epoch)
                self.logger.info(f"epoch {epoch} val: {val_log}")
                log.update({f"val_{k}": v for k, v in val_log.items()})
                improved = self._checkpoint(epoch, val_log["mean_error"])
                self._not_improved = 0 if improved else self._not_improved + 1
                if self._not_improved >= self.cfg.trainer.early_stop:
                    self.logger.info(f"early stop after {self._not_improved} stale epochs")
                    history.append(log)
                    break
            else:
                self._checkpoint(epoch, self.ckpt.best)
            history.append(log)
        return history

    def _checkpoint(self, epoch, value) -> bool:
        """The manager's best/last policy, each save recorded."""
        improved = self.ckpt.step(epoch, value, self.state_dict(),
                                  extra_meta={"global_step": self.global_step})
        self._record_saves()
        return improved
