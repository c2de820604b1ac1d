"""Batching for the eval dataset.

Port of `collate` from `mvsformer_tpu/data/loader.py`, and an eval loader:
a `torch.utils.data.DataLoader` in dataset order (no shuffle, the last
batch kept partial) over the same `collate`, so batches stay dicts of numpy
arrays as the JAX loader gives them. The JAX loader's seeded shuffle,
per-host sharding and crop-size barrels serve training and several hosts:
they come with ROADMAP A4 and A5.
"""

from __future__ import annotations

import numpy as np
import torch.utils.data


def collate(samples):
    """Stack a list of sample dicts into one batch dict (numpy)."""
    out = {}
    first = samples[0]
    for k, v in first.items():
        if isinstance(v, dict):
            out[k] = collate([s[k] for s in samples])
        elif isinstance(v, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def eval_loader(dataset, batch_size=1):
    """Batches of `dataset` in order, read in the calling process."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=False, drop_last=False, collate_fn=collate)
