"""``paddle.io`` (counterpart of ``paddle_tpu/io/__init__.py``): datasets,
samplers and the ``DataLoader``.

The loader hands out batches as the port's ``Tensor``, on the device that
``places`` names, else the one ``set_device`` names (default the card;
with no card and no ``set_device("cpu")`` iterating raises): each paths'
CPU batch is copied there as it is handed out, pinned first and copied
without blocking the host when it goes to the card. The samplers draw from numpy's global ``np.random``, as
the reference's do, so one ``np.random.seed`` gives both packages the same
order. The loader takes one of four paths, as the reference's does:

- a dataset with ``get_arrays()``, the default sampler and the default
  collate: the C++ batcher (``native_batcher``, the repo-root
  ``csrc/batcher.cpp``), whatever ``num_workers`` says;
- ``num_workers > 0``: worker processes with a shared-memory ring
  (``worker``);
- ``num_workers == 0``: one background thread that batches ahead
  (``use_buffer_reader``, the default), or batching inline.

Every emitted batch passes the ``dataloader.next`` fault site
(``utils.faults``): ``bad_batch`` turns its floats into NaN before it is
delivered, as in the reference.
"""
from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tensor import wrap
from ..utils import faults

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ConcatDataset", "ChainDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader",
    "get_worker_info", "default_collate_fn",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = self.cum[ds_idx - 1] if ds_idx else 0
        return self.datasets[ds_idx][idx - prev]

    def __len__(self):
        return self.cum[-1] if self.cum else 0


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(n, float) for n in lengths):  # fractions
        total = len(dataset)
        lengths = [int(math.floor(total * f)) for f in lengths]
        lengths[-1] += total - sum(lengths)
    idx = np.random.permutation(sum(lengths))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, idx[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        return _batches(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space over data-parallel ranks. ``num_replicas``
    and ``rank`` default to ``torch.distributed``'s world size and rank
    when its process group is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:self.total_size - n]
        local = indices[self.local_rank:self.total_size:self.nranks]
        return _batches(local, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The running worker's id, worker count and dataset inside a loader
    worker process; None in the main process."""
    return _worker_info


def _set_worker_info(info):
    global _worker_info
    _worker_info = info


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors: arrays and tensors along a
    new first axis, ints to int64, floats to float32; tuples, lists and
    dicts field by field; anything else is returned as the list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _first_place(places):
    if isinstance(places, (list, tuple)):
        return places[0] if places else None
    return places


def _poison_collated(batch):
    """NaN-fill the floating leaves of a collated batch (the
    ``dataloader.next:bad_batch`` fault — a corrupt reader shard)."""
    if isinstance(batch, torch.Tensor):
        if batch.is_floating_point():
            return torch.full_like(batch, float("nan"))
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_poison_collated(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _poison_collated(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray) and np.issubdtype(batch.dtype,
                                                       np.floating):
        return np.full_like(batch, np.nan)
    return batch


def _deliver(batch, device):
    """A collated CPU batch as Tensors on ``device`` (pinned, then copied
    without blocking the host, when that is the card)."""
    if isinstance(batch, torch.Tensor):
        if device.type == "cuda" and batch.device.type == "cpu":
            if not batch.is_pinned():
                batch = batch.pin_memory()
            batch = batch.to(device, non_blocking=True)
        elif batch.device != device:
            batch = batch.to(device)
        return wrap(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_deliver(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _deliver(v, device) for k, v in batch.items()}
    return batch


class DataLoader:
    """Batched loader over a map-style or iterable dataset (see the module
    docstring for its paths)."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.persistent_workers = persistent_workers
        self._mp_iter = None  # the live workers when persistent_workers
        self.iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        # the C++ batcher takes the default sampler's uniform batches only
        self._own_sampler = batch_sampler is None and not self.iterable_mode
        if self.iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self.iterable_mode:
            raise TypeError("IterableDataset-backed DataLoader has no len()")
        return len(self.batch_sampler)

    def _native_arrays(self):
        """The dataset's whole arrays for the C++ batcher, or None when
        this loader cannot use it (an iterable dataset, a custom collate or
        sampler, no ``get_arrays``, or a transform: ``get_arrays`` gives
        None)."""
        if (self.iterable_mode or self.collate_fn is not default_collate_fn
                or not self._own_sampler):
            return None
        get = getattr(self.dataset, "get_arrays", None)
        if get is None:
            return None
        from .native_batcher import supported

        if not supported():
            return None
        return get()

    def _native_iter(self, arrays):
        from .native_batcher import NativeBatcher

        flat = [i for batch in self.batch_sampler for i in batch]
        nb = NativeBatcher(arrays, flat, self.batch_size,
                           drop_last=self.drop_last,
                           prefetch=max(2, self.prefetch_factor))
        try:
            for outs in nb:
                yield [torch.from_numpy(o) for o in outs]
        finally:
            nb.close()

    def _raw_iter(self):
        arrays = self._native_arrays()
        if arrays is not None:
            yield from self._native_iter(arrays)
            return
        if self.iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if self.batch_size is not None and \
                        len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        # dataloader.next fault site: per emitted batch; "bad_batch"
        # NaN-poisons the floats, error / delay propagate as usual. One
        # no-op inject call per batch when no plan is armed.
        dev = resolve_device(_first_place(self.places))
        for i, batch in enumerate(self._cpu_iter()):
            if faults.inject("dataloader.next", batch=i) == "bad_batch":
                batch = _poison_collated(batch)
            yield _deliver(batch, dev)

    def _cpu_iter(self):
        if self.num_workers > 0:
            arrays = self._native_arrays()
            if arrays is not None:
                yield from self._native_iter(arrays)
                return
            from .worker import MultiProcessLoaderIter

            if self.persistent_workers and not self.iterable_mode:
                # the workers outlive the epoch; start anew only if one died
                if self._mp_iter is None or not self._mp_iter.alive():
                    if self._mp_iter is not None:
                        self._mp_iter.close()
                    self._mp_iter = MultiProcessLoaderIter(self)
                yield from self._mp_iter
                return
            it = MultiProcessLoaderIter(self)
            try:
                yield from it
            finally:
                it.close()
            return
        if not self.use_buffer_reader:
            yield from self._raw_iter()
            return
        yield from self._buffered_iter()

    def _buffered_iter(self):
        """``_raw_iter`` run ahead by one background thread, at most
        ``prefetch_factor`` batches."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        stop = threading.Event()
        err = []

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._raw_iter():
                    if not put(b):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="dataloader-producer")
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    if err:
                        raise err[0]
                    return
                yield b
        finally:
            stop.set()      # the consumer stopped: retire the producer
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
