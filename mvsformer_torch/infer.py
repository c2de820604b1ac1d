"""Eval forward for serving depth maps.

Port of `make_infer_fn` from `mvsformer_tpu/infer.py` (single device; the
mesh form, `save_depth`, the eval dataset and fusion come with later
slices).
"""

from __future__ import annotations

import torch


def make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0)):
    """Return fn(imgs, projs, depth_values) -> (refined_depth,
    photometric_confidence, stage_confs).

    imgs [B, V, H, W, 3], projs {stageK: [B, V, 2, 4, 4]}, depth_values
    [B, Dfull], as tensors or numpy arrays; they are moved to the model's
    device. stage_confs is the list of per-stage confidences at each stage's
    own resolution. (The JAX version's `want_stage_confs` lets XLA drop
    them; eager PyTorch computes them either way, so there is no such flag.)
    """
    device = next(model.parameters()).device
    nstages = len(model.cfg.ndepths)

    def fn(imgs, projs, depth_values):
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=device)
        projs = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in projs.items()}
        depth_values = torch.as_tensor(depth_values, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(imgs, projs, depth_values, tmp=list(tmps))
        stage_confs = [out[f"stage{i}"]["photometric_confidence"]
                       for i in range(1, nstages + 1)]
        return out["refined_depth"], out["photometric_confidence"], stage_confs

    return fn
