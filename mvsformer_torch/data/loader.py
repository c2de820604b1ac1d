"""Batching: `collate`, the in-order eval loader and the training loader.

Port of `mvsformer_tpu/data/loader.py`. `MVSLoader` is the JAX package's
epoch loader: `set_epoch` draws the epoch's permutation from a seeded
generator, pads it so every host gets the same count (DistributedSampler's
rule), keeps this host's stride of it, and re-barrels the dataset over that
order, so each batch shares one crop size. Iterating reads each batch's
samples on a pool of `num_workers` threads, one batch at a time, into a
bounded queue of `prefetch` batches that the caller drains; batches stay
dicts of numpy arrays, as the JAX loader gives them.

The workers share the dataset's one `Generator` (as the JAX loader's do), so
with more than one worker a sample's crop and jitter depend on the order in
which the threads reach it (ROADMAP E5); with one worker they are the
serial draws.

`eval_loader` is the test pipeline's loader: a `torch.utils.data.DataLoader`
in dataset order (a data rank's share of it), the last batch kept partial.
`ViewGroupLoader` shares a loader's batches over a view group.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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


def eval_loader(dataset, batch_size=1, indices=None):
    """Batches of `dataset` in order (of its `indices` only, where given:
    a data rank's share), read in the calling process."""
    if indices is not None:
        dataset = torch.utils.data.Subset(dataset, list(indices))
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=False, drop_last=False, collate_fn=collate)


class MVSLoader:
    """Epoch iterator with a seeded shuffle, a host split and threaded
    prefetch. `load_ms` holds the host ms of every sample read in the
    latest pass (each worker appends its own)."""

    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 num_workers=4, seed=0, host_id=0, num_hosts=1, prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self._epoch = 0
        self._host_idx = None
        self.load_ms: list[float] = []

    def set_epoch(self, epoch: int):
        """The epoch's order: a permutation from seed + epoch, padded to a
        multiple of the host count, this host's stride of it; then the
        dataset's barrels over that order, at this loader's batch size."""
        self._epoch = epoch
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + epoch)
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        per_host = -(-n // self.num_hosts)
        padded = np.concatenate([idx, idx[: per_host * self.num_hosts - n]])
        self._host_idx = padded[self.host_id::self.num_hosts]
        if hasattr(self.dataset, "reset_dataset"):
            self.dataset.batch_size = self.batch_size
            self.dataset.reset_dataset(self._host_idx)

    def __len__(self):
        if self._host_idx is None:
            self.set_epoch(0)
        n = len(self._host_idx)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _read(self, i):
        t0 = time.perf_counter()
        sample = self.dataset[i]
        self.load_ms.append((time.perf_counter() - t0) * 1e3)
        return sample

    def __iter__(self):
        if self._host_idx is None:
            self.set_epoch(self._epoch)
        idx = self._host_idx
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        self.load_ms = []
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):  # gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        put(collate(list(pool.map(self._read, b.tolist()))))
                put(None)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


class ViewGroupLoader:
    """A loader shared by the ranks of a view group (`parallel/mesh.Layout`
    with view > 1), which must train on the same samples: the rank at view
    index 0 iterates `loader` and broadcasts each batch over the group, the
    others receive them. Every rank builds `loader` alike (the same host
    share), so its length and epochs agree; the broadcast keeps the
    samples equal where the dataset's draws would not be (its workers
    share one generator, E5)."""

    def __init__(self, loader, layout):
        self.loader = loader
        self.layout = layout

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    @property
    def load_ms(self):
        return self.loader.load_ms

    def __iter__(self):
        import torch.distributed as dist

        lead, group = self.layout.view_lead, self.layout.view_group
        if self.layout.rank == lead:
            for batch in self.loader:
                dist.broadcast_object_list([batch], src=lead, group=group)
                yield batch
        else:
            for _ in range(len(self.loader)):
                box = [None]
                dist.broadcast_object_list(box, src=lead, group=group)
                yield box[0]
