"""Checkpoints: the best/last/step policy on a monitored metric.

Port of `mvsformer_tpu/train/checkpoint.py` with the JAX package's policy:
`step` saves `model_best` when the monitored metric improves and
`model_last` every `save_period` epochs; the trainer saves `model_step`
every `save_every_steps` optimizer steps. Each checkpoint is one
`torch.save` file `<name>.pth` in the reference's layout (`base_trainer.py`:
{arch, epoch, state_dict, optimizer, monitor_best, config}), with the LR
scheduler's state and `global_step` added, so `load_reference_checkpoint`
reads its model part. Beside it the JSON sidecar `<name>.meta.json` holds
the JAX package's keys (epoch, monitor_metric, monitor_value, monitor_best,
global_step, and batch_idx for `model_step`). Both files are written to a
temporary name and moved into place with `os.replace`, so a run stopped
mid-write leaves the previous checkpoint whole. A JAX run's orbax
directories (`model_best/`, ...) are read once `tools/orbax_to_torch.py`
has converted them into this layout, where JAX and orbax are installed;
finding only those directories raises, naming that command (`ORBAX_HINT`).
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

ORBAX_HINT = ("{what} is a JAX orbax checkpoint directory, which the port reads once "
              "converted: run `python tools/orbax_to_torch.py {run_dir} <out_dir>` where JAX "
              "and orbax are installed, then read <out_dir> instead")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitor: str = "min mean_error", save_period: int = 1,
                 write: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.write = write  # False: the policy runs (best, improved), no file is written
        if write:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        mode, metric = monitor.split()
        if mode not in ("min", "max"):
            raise ValueError(f"monitor mode must be min or max, got {mode!r}")
        self.mode = mode
        self.metric = metric
        self.save_period = save_period
        self.best = math.inf if mode == "min" else -math.inf
        self.saves: list[dict] = []  # {name, ms, bytes} of each save, for the caller to take

    def improved(self, value: float) -> bool:
        return value < self.best if self.mode == "min" else value > self.best

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name + ".pth")

    def _save(self, name: str, state: dict, meta: dict):
        """Write `state` (with the meta's epoch and monitor_best) to
        <name>.pth, then the sidecar, each through a temporary file. A
        manager made with write=False (a data-parallel rank other than 0)
        writes nothing."""
        if not self.write:
            return
        t0 = time.perf_counter()
        path = self.path(name)
        payload = dict(state, epoch=meta.get("epoch"), monitor_best=meta.get("monitor_best"))
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        meta_path = os.path.join(self.ckpt_dir, name + ".meta.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(meta_path + ".tmp", meta_path)
        self.saves.append({"name": name, "ms": (time.perf_counter() - t0) * 1e3,
                           "bytes": os.path.getsize(path)})

    def step(self, epoch: int, value: float, state: dict, extra_meta=None) -> bool:
        """Apply the best/last policy after a validation epoch; True if
        `value` improved on the best so far."""
        meta = {"epoch": epoch, "monitor_metric": self.metric,
                "monitor_value": float(value), "monitor_best": float(self.best)}
        if extra_meta:
            meta.update(extra_meta)
        is_best = self.improved(value)
        if is_best:
            self.best = value
            meta["monitor_best"] = float(self.best)
            self._save("model_best", state, meta)
        if epoch % self.save_period == 0:
            self._save("model_last", state, meta)
        return is_best

    def restore(self, name: str):
        """-> (the saved dict, loaded to the CPU; its sidecar meta). The
        meta's monitor_best becomes this manager's best."""
        if not self.has(name):
            self.refuse_orbax([name])
        state = torch.load(self.path(name), map_location="cpu", weights_only=False)
        meta = self.peek_meta(name)
        self.best = meta.get("monitor_best", self.best)
        return state, meta

    def has(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def refuse_orbax(self, names) -> None:
        """Raise, naming the converter, where one of `names` is an orbax
        directory (a JAX run's checkpoint) and not a `.pth`."""
        for name in names:
            if os.path.isdir(os.path.join(self.ckpt_dir, name)):
                raise ValueError(ORBAX_HINT.format(what=f"{name} in {self.ckpt_dir}",
                                                   run_dir=self.ckpt_dir))

    def peek_meta(self, name: str) -> dict:
        """A checkpoint's sidecar meta, without reading its tensors ({} if none)."""
        path = os.path.join(self.ckpt_dir, name + ".meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)
