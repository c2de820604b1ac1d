"""Phase 1 of the test pipeline: serve depth maps and save them for fusion.

Port of `mvsformer_tpu/infer.py`: `make_infer_fn` (the eval forward) and
`save_depth` (the loop over a scan list that writes `depth_est/*.pfm`,
`confidence/*.npy`, `cams/*_cam.txt`, `images/*.jpg` and, where ground
truth is there, `depth_metric.txt`), on one device or as one rank of a
data x view x depth grid (the model's layout, `parallel/mesh.py`; the JAX
version's mesh form): the data ranks take disjoint shares of the reference
views, the ranks of a view and depth group serve the same views (a block
of the source views each, a slab of each stage's depth hypotheses each),
and one rank of each such group writes.

`images/*.jpg` keeps the JAX package's file name but holds PNG bytes (the
port has no JPEG codec): the reference image is saved without loss, and a
reader that sniffs the content, as `cv2.imread` and the port's `read_image`
do, reads it under either name.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mvsformer_torch import resolve_device
from mvsformer_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from mvsformer_torch.data.eval_dataset import MVSEvalDataset
from mvsformer_torch.data.loader import eval_loader
from mvsformer_torch.parallel.mesh import Layout
from mvsformer_torch.utils import metrics as metric_lib
from mvsformer_torch.utils.cams import CameraParams, write_cam_file
from mvsformer_torch.utils.image import resize_nearest, write_png
from mvsformer_torch.utils.pfm import save_pfm

STAGES = ("stage1", "stage2", "stage3", "stage4")


def make_infer_fn(model, tmps=(5.0, 5.0, 5.0, 1.0)):
    """Return fn(imgs, projs, depth_values) -> (refined_depth,
    photometric_confidence, stage_confs).

    imgs [B, V, H, W, 3], projs {stageK: [B, V, 2, 4, 4]}, depth_values
    [B, Dfull], as tensors or numpy arrays; they are moved to the model's
    device. stage_confs is the list of per-stage confidences at each stage's
    own resolution. (The JAX version's `want_stage_confs` lets XLA drop
    them; eager PyTorch computes them either way, so there is no such flag.)

    A model built with a layout serves as one rank of it: the samples are
    this rank's (a data rank feeds its own), the forward keeps the
    reference view and this rank's block of the source views, regularises
    this rank's slab of each stage's depth hypotheses, and every rank of a
    view and depth group returns the outputs of the whole request (the
    same up to cuDNN's transposed 3D convs, which are not deterministic on
    the card).
    """
    device = next(model.parameters()).device
    nstages = len(model.cfg.ndepths)
    layout = getattr(model, "layout", None)

    def fn(imgs, projs, depth_values):
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=device)
        projs = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in projs.items()}
        if layout is not None:
            imgs, projs = layout.local_request(imgs, projs)
        depth_values = torch.as_tensor(depth_values, dtype=torch.float32, device=device)
        with torch.inference_mode():
            out = model(imgs, projs, depth_values, tmp=list(tmps))
        stage_confs = [out[f"stage{i}"]["photometric_confidence"]
                       for i in range(1, nstages + 1)]
        return out["refined_depth"], out["photometric_confidence"], stage_confs

    return fn


def _on(model, device: torch.device) -> None:
    at = next(model.parameters()).device
    if at.type != device.type or (device.index is not None and at.index != device.index):
        raise ValueError(f"the model is on {at}, not on {device}: build it there")


def save_depth(model, testlist, datapath, outdir, num_view=5, ndepths=192,
               interval_scale=1.06, max_h=1152, max_w=1536, tmps=(5.0, 5.0, 5.0, 1.0),
               dataset="dtu", batch_size=1, combine_conf=True, use_short_range=False,
               device=None, logger=print, timings=None):
    """Run the model (already on `device`: `cuda` unless the caller asks for
    the CPU) over every reference view of every scan in `testlist` and write
    its artifacts under `outdir`. Returns the averaged depth metrics where
    the scans have ground truth, else None.

    Each request is read, run and written in turn: the JAX version's overlap
    of one request's readback and writes with the next forward is not ported
    (ROADMAP B). With a list as `timings`, each request appends its host ms:
    "load_ms" (the dataset), "forward_ms" (inputs to the device, the
    forward, the metrics, and the outputs back to the host) and "write_ms"
    (the files).

    As one rank of the model's layout: data rank d serves the reference
    views d, d + data, ... of the dataset's order in batches of
    `batch_size`. The data ranks exchange nothing during a forward, so the
    shares need no padding and no view is served twice (the JAX version
    pads its last batch to the data axis and drops the pad's outputs). The
    ranks of a view and depth group read the same views (the eval dataset
    draws nothing at random) and the one at view and depth index 0 writes
    their files.
    Those ranks gather every batch's metrics to each other and sum them in
    the dataset's order, the single process's sum; rank 0 writes
    `depth_metric.txt` and the other ranks of view index 0 return the same
    metrics. Every rank waits for the others before it returns, so the
    files are whole when it does."""
    dev = resolve_device(device)
    _on(model, dev)
    layout = getattr(model, "layout", None) or Layout()
    if (num_view - 1) % layout.view:
        raise ValueError(f"num_view {num_view}: num_view - 1 source views do not split over "
                         f"{layout.view} view ranks")
    writer = layout.view_index == 0 and layout.depth_index == 0
    infer = make_infer_fn(model, tmps)
    ds = MVSEvalDataset(datapath, testlist, nviews=num_view, ndepths=ndepths,
                        interval_scale=interval_scale, max_h=max_h, max_w=max_w,
                        dataset=dataset, use_short_range=use_short_range)
    share = range(layout.data_index, len(ds), layout.data)
    loader = iter(eval_loader(ds, batch_size=batch_size, indices=share))

    batch_metrics = []  # (the batch's first index in the dataset, its metrics)
    n_batches = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(loader, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        projs = {k: v for k, v in batch["proj_matrices"].items() if k in STAGES}
        depth, conf, stage_confs = infer(batch["imgs"], projs, batch["depth_values"])
        dv = batch["depth_values"]
        if "depth_gt" in batch and writer:
            di = float(dv[0, 1] - dv[0, 0]) / 2.65
            gt = torch.as_tensor(batch["depth_gt"], device=dev)
            mask = torch.as_tensor(batch["mask"], device=dev) > 0.5
            batch_metrics.append((share[n_batches * batch_size], {
                k: float(v) for k, v in metric_lib.depth_metrics(depth, gt, mask, di).items()}))
        if not combine_conf:
            h, w = depth.shape[1:]
            conf = torch.stack([torch.stack([resize_nearest(c[b], (h, w)) for c in stage_confs])
                                for b in range(depth.shape[0])])
        depth, conf = depth.cpu().numpy(), conf.cpu().numpy()
        t2 = time.perf_counter()
        if writer:
            _write_artifacts(outdir, batch, depth, conf, ndepths)
        t3 = time.perf_counter()
        n_batches += 1
        if timings is not None:
            timings.append({"load_ms": (t1 - t0) * 1e3, "forward_ms": (t2 - t1) * 1e3,
                            "write_ms": (t3 - t2) * 1e3})

    total = time.perf_counter() - t_start
    logger(f"avg time per batch: {total / max(n_batches, 1):.3f}s over {n_batches} batches "
           f"(read, forward and write in turn)")
    metrics = None
    if writer:
        if layout.data > 1:
            gathered = [None] * layout.data
            dist.all_gather_object(gathered, batch_metrics, group=layout.data_group)
            batch_metrics = sorted((m for part in gathered for m in part), key=lambda m: m[0])
        if batch_metrics:
            metric_sum: dict = {}
            for _, m in batch_metrics:
                for k, v in m.items():
                    metric_sum[k] = metric_sum.get(k, 0.0) + v
            metrics = {k: v / len(batch_metrics) for k, v in metric_sum.items()}
            if layout.rank == 0:
                with open(os.path.join(outdir, "depth_metric.txt"), "w") as f:
                    for k, v in metrics.items():
                        f.write(f"{k}: {v}\n")
            logger(f"depth metrics: {metrics}")
    if layout.world > 1:
        dist.barrier()
    return metrics


def _write_artifacts(outdir, batch, depth, conf, ndepths):
    dv = batch["depth_values"]
    for b, filename in enumerate(batch["filename"]):
        paths = {kind: os.path.join(outdir, filename.format(kind, ext)) for kind, ext in (
            ("depth_est", ".pfm"), ("confidence", ".npy"), ("cams", "_cam.txt"),
            ("images", ".jpg"))}
        for p in paths.values():
            os.makedirs(os.path.dirname(p), exist_ok=True)
        save_pfm(paths["depth_est"], depth[b])
        np.save(paths["confidence"], conf[b])
        ref = batch["proj_matrices"]["stage4"][b, 0]
        write_cam_file(paths["cams"], CameraParams(
            extrinsic=np.asarray(ref[0]),
            intrinsic=np.asarray(ref[1, :3, :3]),
            depth_min=float(dv[b, 0]),
            depth_interval=float(dv[b, 1] - dv[b, 0]),
            num_depth=float(ndepths),
            depth_max=float(dv[b, -1]),
        ))
        img = np.asarray(batch["imgs"][b, 0]) * IMAGENET_STD + IMAGENET_MEAN
        write_png(paths["images"], np.clip(img * 255, 0, 255).astype(np.uint8))
