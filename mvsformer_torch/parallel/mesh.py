"""The (data, view) process grid: one process per GPU, its groups and its
collectives.

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
- "depth": the JAX package's depth-slab sharding of the cost volume
  (`stagenet.py:334-336`, a GSPMD constraint whose 3D U-Net halo exchange
  XLA inserts) has no torch counterpart short of an exchange written by
  hand around every 3D conv of `models/costreg.py`: ROADMAP A5b. A depth
  axis above 1 raises.

Rank r sits where `make_mesh`'s `np.asarray(devices).reshape(data, view,
depth)` puts device r: (d, v) = divmod(r, view). The JAX mesh idles the
devices it does not use on one host; here a spare process would wait at
its first collective for ever, so the grid must use every process.
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
DEPTH_REFUSAL = ("a depth axis above 1 (the cost volume's depth slabs) is not ported: it "
                 "needs a halo exchange written by hand around every 3D conv of the cost "
                 "regularisers (ROADMAP A5b)")


def grid_shape(world: int, data: int = -1, view: int = 1, depth: int = 1) -> tuple:
    """(data, view, depth) over `world` processes; data -1 absorbs what view
    and depth leave, as `make_mesh` does. Raises for a depth axis above 1
    (A5b) and for a grid that does not use exactly `world` processes."""
    if depth != 1:
        raise NotImplementedError(DEPTH_REFUSAL)
    if view < 1 or (data < 1 and data != -1):
        raise ValueError(f"axis sizes must be positive (data may be -1): data {data}, "
                         f"view {view}")
    if data == -1:
        if world % view:
            raise ValueError(f"{world} processes do not split into view groups of {view} "
                             f"(start a multiple of {view} processes with torchrun)")
        data = world // view
    if data * view != world:
        raise ValueError(f"a data {data} x view {view} grid needs {data * view} processes, "
                         f"and {world} are running: every process must sit on the grid "
                         f"(start them with torchrun --nproc_per_node {data * view})")
    return data, view, 1


def grid_position(rank: int, data: int, view: int, depth: int = 1) -> tuple:
    """(d, v, z) of `rank`: its index in `np.arange(world).reshape(data,
    view, depth)`, where `make_mesh` puts device `rank`."""
    return tuple(int(i) for i in np.unravel_index(rank, (data, view, depth)))


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """This process's place on a data x view grid and its two groups:
    `data_group` the ranks at its view index (they split the batch: SyncBN,
    and the gradients' mean), `view_group` the ranks at its data index
    (they split one sample's source views). A group is None where its axis
    has size 1. `Layout()` is one process."""

    data: int = 1
    view: int = 1
    rank: int = 0
    data_group: Any = None
    view_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.view

    @property
    def data_index(self) -> int:
        return self.rank // self.view

    @property
    def view_index(self) -> int:
        return self.rank % self.view

    @property
    def view_lead(self) -> int:
        """The global rank at view index 0 of this rank's view group."""
        return self.data_index * self.view

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
    """This process's `Layout` on a data x view grid over the running
    process group (one process without one). Every process calls it, and
    each builds one group per data index and one per view index, in the
    same order."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    data, view, _ = grid_shape(world, data, view, depth)
    if world == 1:
        return Layout()
    ranks = np.arange(world).reshape(data, view)
    data_groups = [dist.new_group(ranks[:, v].tolist()) if data > 1 else None
                   for v in range(view)]
    view_groups = [dist.new_group(ranks[d].tolist()) if view > 1 else None
                   for d in range(data)]
    d, v, _ = grid_position(rank, data, view)
    return Layout(data, view, rank, data_groups[v], view_groups[d])


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


def start(args):
    """The CLIs' process setup -> (device, Layout), from their
    `--device`, `--data_parallel`, `--view_parallel`, `--depth_parallel`,
    `--dist_backend`, `--dist_url` and the train CLI's `--multi_host` (the
    test CLI serves on one node). Under torchrun (WORLD_SIZE set, even to
    1) every process joins the process group and the first collective runs
    on the backend chosen; without it the grid is one process, and asking
    for more raises."""
    multi_host = getattr(args, "multi_host", False)
    if args.depth_parallel != 1:
        raise NotImplementedError(DEPTH_REFUSAL)
    if "WORLD_SIZE" not in os.environ:
        if multi_host:
            raise RuntimeError("--multi_host: start the processes with torchrun, whose "
                               "variables name the nodes")
        return resolve_device(args.device), make_layout(args.data_parallel, args.view_parallel)
    world = int(os.environ["WORLD_SIZE"])
    if int(os.environ.get("LOCAL_WORLD_SIZE", world)) != world and not multi_host:
        raise ValueError(f"the {world} processes span several nodes: pass --multi_host "
                         f"(the train CLI; the test CLI serves on one node)")
    device = init_distributed(args.dist_backend, args.device, args.dist_url)
    layout = make_layout(args.data_parallel, args.view_parallel)
    dist.all_reduce(torch.ones(1, device=device))  # every rank is up
    return device, layout


def stop() -> None:
    """Leave the process group the CLIs joined, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
