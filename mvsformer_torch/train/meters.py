"""Running means of a dict of scalars (port of `mvsformer_tpu/train/meters.py`)."""

from __future__ import annotations

import math


class DictAverageMeter:
    def __init__(self):
        self.data = {}
        self.count = 0

    def update(self, new_input: dict, n: int = 1):
        """Add one weighted record; raises on a non-finite value."""
        self.count += n
        for k, v in new_input.items():
            v = float(v)
            if not math.isfinite(v):
                raise ValueError(f"meter input {k} is not finite: {v}")
            self.data[k] = self.data.get(k, 0.0) + v * n

    def mean(self) -> dict:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}

    def reset(self):
        self.data = {}
        self.count = 0
