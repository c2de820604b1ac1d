"""The (data, view, depth) process grid: one process per GPU, its groups
and its collectives.

Port of `mvsformer_tpu/parallel/mesh.py` over `torch.distributed`. The
JAX package runs one program over a ("data", "view", "depth") mesh of
devices; the port runs one process per GPU (the reference's DDP layout,
`torchrun`), and each process computes what `shard_map` computes on one
device of that mesh:

- "data": the batch is split over the data ranks. Gradients are averaged
  over them (DDP), and the BN statistics of a training forward are
  synchronised over them (SyncBN, `models/blocks.FoldedBatchNorm`).
- "view": the source views of a sample are split over the view ranks.
  Each warps and correlates its own sources and the reference view, whose
  features every view rank computes; `models/stagenet.StageNet` completes
  the weighted view sum and the sum of the weights with one all-reduce
  over the view group.
- "depth" (serving only): the JAX package's depth-slab sharding of the
  cost volume (`stagenet.py:334-336`, a GSPMD constraint on `volume_mean`
  whose 3D U-Net halo exchange XLA inserts). Every depth rank computes
  the whole volume, then regularises its slab of the depth hypotheses
  with the halo exchange written out in `parallel/depth.py`, and gathers
  the logits for the decode. Training over a depth axis raises (ROADMAP
  A5b, training).

Rank r sits where `make_mesh`'s `np.asarray(devices).reshape(data, view,
depth)` puts device r: (d, v, z) = np.unravel_index(r, (data, view,
depth)). The JAX mesh idles the devices it does not use on one host; here
a spare process would wait at its first collective for ever, so the grid
must use every process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from mvsformer_torch import resolve_device

AXES = ("data", "view", "depth")
TRAIN_DEPTH_REFUSAL = ("training over a depth axis above 1 is not ported: it needs gradients "
                       "through the depth slabs' halo exchange, BN statistics over the slabs "
                       "and gradients summed over the depth group (ROADMAP A5b, training); "
                       "the depth axis serves only")


def grid_shape(world: int, data: int = -1, view: int = 1, depth: int = 1) -> tuple:
    """(data, view, depth) over `world` processes; data -1 absorbs what view
    and depth leave, as `make_mesh` does. Raises for a grid that does not
    use exactly `world` processes."""
    if view < 1 or depth < 1 or (data < 1 and data != -1):
        raise ValueError(f"axis sizes must be positive (data may be -1): data {data}, "
                         f"view {view}, depth {depth}")
    groups = f"view groups of {view}" if depth == 1 else \
        f"view x depth groups of {view} x {depth}"
    if data == -1:
        if world % (view * depth):
            raise ValueError(f"{world} processes do not split into {groups} (start a "
                             f"multiple of {view * depth} processes with torchrun)")
        data = world // (view * depth)
    need = data * view * depth
    if need != world:
        grid = f"data {data} x view {view}" + (f" x depth {depth}" if depth > 1 else "")
        raise ValueError(f"a {grid} grid needs {need} processes, and {world} are running: "
                         f"every process must sit on the grid (start them with torchrun "
                         f"--nproc_per_node {need})")
    return data, view, depth


def grid_position(rank: int, data: int, view: int, depth: int = 1) -> tuple:
    """(d, v, z) of `rank`: its index in `np.arange(world).reshape(data,
    view, depth)`, where `make_mesh` puts device `rank`."""
    return tuple(int(i) for i in np.unravel_index(rank, (data, view, depth)))


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """This process's place on a data x view x depth grid and its groups:
    `data_group` the ranks at its (view, depth) index (they split the
    batch: SyncBN, and the gradients' mean), `view_group` the ranks at its
    (data, depth) index (they split one sample's source views),
    `depth_group` the ranks at its (data, view) index (they split the cost
    volume's depth hypotheses). A group is None where its axis has size 1.
    `Layout()` is one process."""

    data: int = 1
    view: int = 1
    rank: int = 0
    data_group: Any = None
    view_group: Any = None
    depth: int = 1
    depth_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.view * self.depth

    @property
    def data_index(self) -> int:
        return self.rank // (self.view * self.depth)

    @property
    def view_index(self) -> int:
        return self.rank // self.depth % self.view

    @property
    def depth_index(self) -> int:
        return self.rank % self.depth

    @property
    def view_lead(self) -> int:
        """The global rank at view index 0 of this rank's view group."""
        return (self.data_index * self.view) * self.depth + self.depth_index

    def local_views(self, x):
        """x [B, V, ...] -> [B, 1 + (V - 1) / view, ...]: the reference view
        and this rank's contiguous block of the source views (the JAX
        package's `imgs_src` sharded over "view"). Raises where V - 1 does
        not divide by the view size."""
        if self.view == 1:
            return x
        n_src = x.shape[1] - 1
        if n_src % self.view:
            raise ValueError(f"{n_src} source views do not split over {self.view} view ranks "
                             f"(num_view - 1 must divide by the view size)")
        k = n_src // self.view
        s0 = 1 + self.view_index * k
        return torch.cat([x[:, :1], x[:, s0:s0 + k]], dim=1)

    def local_request(self, imgs, projs):
        """`local_views` of the images and of each stage's projections."""
        return self.local_views(imgs), {k: self.local_views(v) for k, v in projs.items()}


def make_layout(data: int = -1, view: int = 1, depth: int = 1) -> Layout:
    """This process's `Layout` on a data x view x depth grid over the
    running process group (one process without one). Every process calls
    it, and each builds one group per (view, depth), per (data, depth) and
    per (data, view) index, in the same order."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    data, view, depth = grid_shape(world, data, view, depth)
    if world == 1:
        return Layout()
    ranks = np.arange(world).reshape(data, view, depth)

    def groups(size, lines):
        return {key: dist.new_group(line.tolist()) if size > 1 else None
                for key, line in lines}

    data_groups = groups(data, (((v, z), ranks[:, v, z])
                                for v in range(view) for z in range(depth)))
    view_groups = groups(view, (((d, z), ranks[d, :, z])
                                for d in range(data) for z in range(depth)))
    depth_groups = groups(depth, (((d, v), ranks[d, v, :])
                                  for d in range(data) for v in range(view)))
    d, v, z = grid_position(rank, data, view, depth)
    return Layout(data, view, rank, data_groups[v, z], view_groups[d, z], depth,
                  depth_groups[d, v])


def init_distributed(backend=None, device=None, init_method="env://") -> torch.device:
    """Join the process group that `torchrun` describes (the torch form of
    `jax.distributed.initialize()`): RANK, WORLD_SIZE and LOCAL_RANK from
    the environment, the rendezvous from `init_method` (env:// reads
    MASTER_ADDR and MASTER_PORT, which torchrun sets on every node).

    Returns this rank's device: `cuda:{LOCAL_RANK}` for `device` None or
    "cuda", `device` itself where it names an index (every rank on that
    card) or the CPU. `backend` is the caller's: nccl by default on CUDA,
    gloo on the CPU; NCCL needs one card per rank, gloo moves CPU and CUDA
    tensors and may put several ranks on one card."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"{e.args[0]} is not set: start the processes with torchrun, "
                           "which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
                           "MASTER_PORT") from None
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if dev.type != "cuda" or torch.cuda.device_count() < local_world:
            raise ValueError(f"nccl needs one CUDA card per rank ({local_world} ranks on this "
                             f"node, {torch.cuda.device_count()} cards); use gloo to share a "
                             f"card or to run on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dev


def all_sum(t, group):
    """Sum of `t` over `group`, differentiable: the backward sums the
    cotangents over the group, the transpose of a psum."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def all_mean(t, group):
    """Mean of `t` over `group`, differentiable (gloo has no AVG)."""
    return all_sum(t, group) / dist.get_world_size(group)


def mean_(tensors, group=None) -> None:
    """Average a list of tensors in place over `group` (the world by
    default), without autograd: one all-reduce per dtype and device over
    the tensors flattened into one buffer."""
    size = dist.get_world_size(group)
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def start(args, train: bool = False):
    """The CLIs' process setup -> (device, Layout), from their
    `--device`, `--data_parallel`, `--view_parallel`, `--depth_parallel`,
    `--dist_backend`, `--dist_url` and the train CLI's `--multi_host` (the
    test CLI serves on one node). Under torchrun (WORLD_SIZE set, even to
    1) every process joins the process group and the first collective runs
    on the backend chosen; without it the grid is one process, and asking
    for more raises. `train`: the train CLI's setup, which refuses a depth
    axis (ROADMAP A5b, training)."""
    multi_host = getattr(args, "multi_host", False)
    if train and args.depth_parallel != 1:
        raise NotImplementedError(TRAIN_DEPTH_REFUSAL)
    grid = (args.data_parallel, args.view_parallel, args.depth_parallel)
    if "WORLD_SIZE" not in os.environ:
        if multi_host:
            raise RuntimeError("--multi_host: start the processes with torchrun, whose "
                               "variables name the nodes")
        return resolve_device(args.device), make_layout(*grid)
    world = int(os.environ["WORLD_SIZE"])
    if int(os.environ.get("LOCAL_WORLD_SIZE", world)) != world and not multi_host:
        raise ValueError(f"the {world} processes span several nodes: pass --multi_host "
                         f"(the train CLI; the test CLI serves on one node)")
    device = init_distributed(args.dist_backend, args.device, args.dist_url)
    layout = make_layout(*grid)
    dist.all_reduce(torch.ones(1, device=device))  # every rank is up
    return device, layout


def stop() -> None:
    """Leave the process group the CLIs joined, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
