"""Sharded batching loader: the port's replacement for torch DataLoader +
DistributedSampler + the per-rank-JSON "fast loader".

A copy of ``text_to_sound_synthesis_tpu/data/loader.py`` with the shard
taken from ``torch.distributed`` (the rank and the world size) in place of
the JAX process index and count. Parity targets: ``build_dataloader``
(``Diffsound/sound_synthesis/data/build.py:404-473`` — ConcatDataset,
DistributedSampler, drop_last) and ``build_dataloader_fast`` (``:476-547`` —
per-rank shards with a shared shuffle seed and per-rank sub-order, equal
iteration counts across ranks).

Semantics preserved (they matter for scheduler parity, SURVEY.md §5):
* every rank sees a disjoint 1/world slice, shuffled with a seed shared
  across ranks (epoch-keyed), so iteration counts are identical everywhere;
* drop_last batching; per-epoch reshuffle (``set_epoch``); random caption
  choice re-drawn per epoch (each __getitem__ gets a fresh epoch-seeded
  generator).

A single background thread prefetches batches (the reference's worker pool is
I/O-bound .npy reading; one thread + the OS page cache keeps up with it).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from ..utils.config import instantiate_from_config

__all__ = ["ShardedLoader", "ConcatDataset", "build_dataloader"]


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index: int, rng=None):
        di = int(np.searchsorted(self._offsets, index, side="right") - 1)
        item = self.datasets[di]
        local = index - int(self._offsets[di])
        try:
            return item.__getitem__(local, rng=rng)
        except TypeError:
            return item[local]


def _collate(items: List[Mapping[str, Any]]) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.number)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals  # e.g. caption strings
    return out


class ShardedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
        prefetch: int = 2,
        num_workers: int = 0,
    ):
        from ..parallel.distributed import get_rank, get_world_size

        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards if num_shards is not None else get_world_size()
        self.shard_index = shard_index if shard_index is not None else get_rank()
        self.prefetch = prefetch
        self.num_workers = num_workers  # >0: thread pool for item IO
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_shard = len(self.dataset) // self.num_shards
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # seed shared across shards -> identical global order, disjoint slices
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        per_shard = n // self.num_shards
        return order[self.shard_index * per_shard : (self.shard_index + 1) * per_shard]

    def __iter__(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        item_rng = np.random.default_rng(
            (self.seed + 1) * 7919 + self.epoch * 131 + self.shard_index
        )
        n_batches = len(self)

        takes_rng = _accepts_rng(self.dataset)

        def fetch(i: int):
            if takes_rng:
                return self.dataset.__getitem__(int(i), rng=item_rng)
            return self.dataset[int(i)]

        # batched fast path: dataset-level load_batch backed by the C++ npy
        # loader (native/npy_batch.cc) — one call per batch, internal thread
        # pool, no GIL. Draws from item_rng in the same per-item order as
        # __getitem__, so switching paths never changes the data stream.
        load_batch = None  # T2S_NATIVE_LOADER=0 falls back to the paths below
        if hasattr(self.dataset, "load_batch"):
            from ..native import native_available

            if native_available():
                load_batch = self.dataset.load_batch

        # If the consumer abandons iteration early (exception in the train
        # loop, a tool taking one batch), the producer must not block forever
        # on a full queue holding batches + its thread pool: every put polls
        # this stop flag, set by the consumer generator's finally.
        stop = threading.Event()

        def safe_put(q: queue.Queue, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            pool = None
            try:
                if load_batch is None and self.num_workers > 0:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = ThreadPoolExecutor(self.num_workers)
                for b in range(n_batches):
                    batch_idx = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    if len(batch_idx) < self.batch_size and self.drop_last:
                        break
                    if load_batch is not None:
                        if not safe_put(q, load_batch(batch_idx, rng=item_rng)):
                            return
                        continue
                    if pool is not None:
                        if takes_rng:
                            # Generator is not thread-safe: per-item children
                            rngs = item_rng.spawn(len(batch_idx))
                            items = list(pool.map(
                                lambda a: self.dataset.__getitem__(int(a[0]), rng=a[1]),
                                zip(batch_idx, rngs)))
                        else:
                            items = list(pool.map(fetch, batch_idx))
                    else:
                        items = [fetch(i) for i in batch_idx]
                    if not safe_put(q, _collate(items)):
                        return
                safe_put(q, None)
            except BaseException as e:  # surface worker errors to the consumer
                safe_put(q, e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
        # auto-advance like DistributedSampler.set_epoch usage — only on full
        # consumption, so an abandoned/retried epoch keeps its shuffle order
        self.epoch += 1


def _accepts_rng(ds) -> bool:
    import inspect

    try:
        return "rng" in inspect.signature(ds.__getitem__).parameters
    except (TypeError, ValueError):
        return False


def build_dataloader(config: Mapping[str, Any], *, seed: int = 0, mesh=None) -> dict:
    """Reference-schema entry: returns {'train_loader', 'validation_loader',
    'train_iterations', 'validation_iterations'} (build.py:404-473).

    The config's ``batch_size`` is the global batch, as in the JAX package:
    each data rank of ``mesh`` (``parallel.mesh``) loads batch / data
    samples from its 1/data shard, so a step's ranks together take the
    batch. Without a mesh the data ranks are the largest count of ranks that
    divides the batch (``make_data_mesh_for_batch``'s), rank order; a rank
    left over gets rank 0's shard and takes no step."""
    from ..parallel.distributed import get_rank, get_world_size
    from ..parallel.mesh import batch_ranks

    dl_cfg = config["dataloader"]
    global_batch = int(dl_cfg.get("batch_size", 1))
    if mesh is None:
        data = batch_ranks(global_batch, get_world_size())
        index = get_rank() if get_rank() < data else 0
    else:
        data, index = mesh.data, mesh.data_index
    if global_batch % data:
        raise ValueError(f"global batch {global_batch} is not a multiple of {data} data ranks")
    batch_size = global_batch // data
    num_workers = int(dl_cfg.get("num_workers", 0))

    def make(split_key: str, shuffle: bool):
        ds_cfgs = dl_cfg.get(split_key) or []
        if not ds_cfgs:
            return None
        datasets = [instantiate_from_config(c) for c in ds_cfgs]
        ds = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
        return ShardedLoader(ds, batch_size, shuffle=shuffle, seed=seed, num_shards=data,
                             shard_index=index, num_workers=num_workers)

    train = make("train_datasets", True)
    val = make("validation_datasets", False)
    return {
        "train_loader": train,
        "validation_loader": val,
        "train_iterations": len(train) if train else 0,
        "validation_iterations": len(val) if val else 0,
    }
