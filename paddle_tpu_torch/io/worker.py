"""``DataLoader`` worker processes with a shared-memory ring (counterpart
of ``paddle_tpu/io/worker.py``).

``num_workers > 0`` forks worker processes. Each owns a ring of reusable
shared-memory slots: it collates its batches into numpy arrays, writes
their bytes into a free slot and sends (skeleton, array specs) through a
result queue; the parent copies the bytes out of the slot into memory it
owns (pinned where the parent uses CUDA), hands the slot back, and
builds CPU tensors on that copy. Batch
``i`` goes to worker ``i % W`` and each worker keeps its order, so the
parent reads the workers round-robin and the order is the sampler's.

The workers are forked (the reference's start method): a dataset of
hundreds of MB is shared copy-on-write instead of pickled to each worker.
The parent may hold a live CUDA context; a worker touches numpy only. The
default collate runs a numpy twin (``_np_collate``), CPU tensors from a
dataset or a custom collate go through ``.numpy()``, and a CUDA tensor in
a worker raises. Workers do not reseed ``np.random`` after the fork, as
the reference's do not, so workers forked from one parent state draw the
same random numbers (random transforms repeat across workers; ROADMAP R10).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

__all__ = ["MultiProcessLoaderIter"]


class _ArrRef:
    """Skeleton placeholder for an array leaf moved through shared memory."""

    __slots__ = ("idx", "kind")

    def __init__(self, idx, kind):
        self.idx = idx
        self.kind = kind  # "tensor": a torch.Tensor in the parent


def _tensor_to_np(t):
    """A CPU tensor's values as numpy, in a worker; a CUDA tensor raises
    (a forked child must not drive the parent's CUDA context)."""
    if t.device.type != "cpu":
        raise RuntimeError(
            f"DataLoader worker received a tensor on {t.device}; datasets "
            "and collate_fns used with num_workers>0 must return numpy "
            "arrays or CPU tensors")
    return t.detach().numpy()


def _encode(obj, arrays):
    if isinstance(obj, torch.Tensor):
        arrays.append(np.ascontiguousarray(_tensor_to_np(obj)))
        return _ArrRef(len(arrays) - 1, "tensor")
    if isinstance(obj, np.ndarray):
        arrays.append(np.ascontiguousarray(obj))
        return _ArrRef(len(arrays) - 1, "ndarray")
    if isinstance(obj, tuple):
        return tuple(_encode(o, arrays) for o in obj)
    if isinstance(obj, list):
        return [_encode(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {k: _encode(v, arrays) for k, v in obj.items()}
    return obj


def _decode(obj, arrays):
    if isinstance(obj, _ArrRef):
        arr = arrays[obj.idx]
        return torch.from_numpy(arr) if obj.kind == "tensor" else arr
    if isinstance(obj, tuple):
        return tuple(_decode(o, arrays) for o in obj)
    if isinstance(obj, list):
        return [_decode(o, arrays) for o in obj]
    if isinstance(obj, dict):
        return {k: _decode(v, arrays) for k, v in obj.items()}
    return obj


def _np_collate(batch):
    """Numpy twin of ``default_collate_fn`` for the workers; the parent
    turns every array leaf into a tensor (``_mark_all_tensor``)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([_tensor_to_np(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (tuple, list)):
        return [_np_collate(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _mark_all_tensor(obj):
    if isinstance(obj, _ArrRef):
        return _ArrRef(obj.idx, "tensor")
    if isinstance(obj, tuple):
        return tuple(_mark_all_tensor(o) for o in obj)
    if isinstance(obj, list):
        return [_mark_all_tensor(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _mark_all_tensor(v) for k, v in obj.items()}
    return obj


class _Slot:
    """One reusable shared-memory segment; a batch that outgrows it makes
    a larger one under a new name (the parent attaches by the name sent
    with each batch)."""

    def __init__(self, wid, idx, size=1 << 20):
        self.idx = idx
        self.gen = 0
        self.wid = wid
        self.shm = shared_memory.SharedMemory(
            create=True, size=size, name=self._name())

    def _name(self):
        return f"pdtpu_torch_{os.getpid()}_{self.wid}_{self.idx}_{self.gen}"

    def ensure(self, nbytes):
        if self.shm.size >= nbytes:
            return
        self.shm.close()
        self.shm.unlink()
        self.gen += 1
        self.shm = shared_memory.SharedMemory(
            create=True, size=max(nbytes, 2 * self.shm.size),
            name=self._name())

    def write(self, arrays):
        specs = []
        off = 0
        self.ensure(sum(a.nbytes for a in arrays))
        for a in arrays:
            dst = np.ndarray(a.shape, a.dtype, buffer=self.shm.buf,
                             offset=off)
            np.copyto(dst, a)
            specs.append((tuple(a.shape), a.dtype.str, off))
            off += a.nbytes
        return self.shm.name, specs

    def destroy(self):
        try:
            self.shm.close()
            self.shm.unlink()
        except (OSError, BufferError):
            pass


def _worker_loop(loader_state, wid, index_q, result_q, free_q, n_slots,
                 stop):
    """A worker process: collate its batches into the slot ring until the
    work runs out or the parent sets ``stop``."""
    (dataset, collate, use_np_collate, worker_init_fn, num_workers,
     iterable, batch_size, drop_last) = loader_state
    from . import _set_worker_info, _WorkerInfo

    _set_worker_info(_WorkerInfo(id=wid, num_workers=num_workers,
                                 dataset=dataset))
    if worker_init_fn is not None:
        worker_init_fn(wid)
    slots = [_Slot(wid, i) for i in range(n_slots)]
    for s in slots:
        free_q.put(s.idx)

    def send(bid, data):
        arrays = []
        skeleton = _encode(data, arrays)
        if use_np_collate:
            skeleton = _mark_all_tensor(skeleton)
        slot_idx = free_q.get()  # backpressure: waits for the parent
        name, specs = slots[slot_idx].write(arrays)
        result_q.put(("ok", bid, slot_idx, name, skeleton, specs))

    try:
        if iterable:
            bid = 0
            batch = []
            for item in dataset:
                if stop.is_set():
                    break
                batch.append(item)
                if batch_size is not None and len(batch) == batch_size:
                    send(bid, collate(batch))
                    bid += 1
                    batch = []
            if batch and not drop_last:
                send(bid, collate(batch))
            result_q.put(("end", None, None, None, None, None))
        else:
            # work items (bid, idxs); "epoch_end" echoes an "end" so the
            # parent can frame epochs (persistent workers); None: shut down
            while True:
                item = index_q.get()
                if item is None or stop.is_set():
                    break
                if item == "epoch_end":
                    result_q.put(("end", None, None, None, None, None))
                    continue
                bid, idxs = item
                send(bid, collate([dataset[i] for i in idxs]))
    except Exception:
        result_q.put(("err", traceback.format_exc(), None, None, None, None))
    finally:
        # the segments outlive the last batch in flight: unless the parent
        # has stopped reading, wait until it has returned every slot (10 s
        # at most), then unlink
        reclaimed = 0
        try:
            while reclaimed < n_slots and not stop.is_set():
                free_q.get(timeout=10)
                reclaimed += 1
        except queue.Empty:
            pass
        for s in slots:
            s.destroy()


def _receive_buffer(nbytes):
    """Memory for one batch in the parent. Where this process already uses
    CUDA, pinned memory from PyTorch's caching host allocator: its pages
    are resident and reused from batch to batch (a fresh 38.5 MB buffer
    costs its page faults on every batch), and the batch then goes to the
    card without another copy. Otherwise a bytearray."""
    if torch.cuda.is_initialized():
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
    return bytearray(nbytes)


def _read_segment(name, nbytes):
    """Copy the first ``nbytes`` of the named shared-memory segment into a
    buffer the caller owns (one copy; the slot goes back to its worker
    right after). Linux exposes segments under /dev/shm, and reading the
    file keeps the parent off the resource tracker; elsewhere it attaches
    without tracking."""
    buf = _receive_buffer(nbytes)
    try:
        with open(f"/dev/shm/{name}", "rb", buffering=0) as f:
            view = memoryview(buf)
            got = 0
            while got < nbytes:
                n = f.readinto(view[got:])
                if not n:
                    raise RuntimeError(f"shared-memory segment {name} ended "
                                       f"at {got} of {nbytes} bytes")
                got += n
        return buf
    except FileNotFoundError:
        seg = shared_memory.SharedMemory(name=name)
        # attaching registered the segment with this process's resource
        # tracker, which would unlink it at exit: its worker owns it
        resource_tracker.unregister(seg._name, "shared_memory")
        try:
            memoryview(buf)[:] = seg.buf[:nbytes]
        finally:
            seg.close()
        return buf


class MultiProcessLoaderIter:
    """Parent-side iterator over a loader's worker processes."""

    #: ``timeout=0`` (Paddle's "no timeout") waits this long for a batch
    #: before it raises: a worker forked while another thread of the parent
    #: held a lock can hang, and a bounded wait turns that into an error
    DEFAULT_READ_TIMEOUT = 600.0

    def __init__(self, loader):
        from . import default_collate_fn

        self._loader = loader
        self._W = loader.num_workers
        ctx = mp.get_context("fork")
        self._workers = []
        self._index_qs = []
        self._result_qs = []
        self._free_qs = []
        self._slot_names: dict[tuple[int, int], str] = {}
        use_np = loader.collate_fn is default_collate_fn
        collate = _np_collate if use_np else loader.collate_fn
        n_slots = self._n_slots = max(2, loader.prefetch_factor)
        self._iterable = loader.iterable_mode
        self._persistent = loader.persistent_workers and not self._iterable
        self._total = None
        self._stop = ctx.Event()
        state = (loader.dataset, collate, use_np, loader.worker_init_fn,
                 self._W, self._iterable, loader.batch_size,
                 loader.drop_last)
        for w in range(self._W):
            iq, rq, fq = ctx.Queue(), ctx.Queue(), ctx.Queue()
            p = ctx.Process(target=_worker_loop,
                            args=(state, w, iq, rq, fq, n_slots, self._stop),
                            daemon=True)
            p.start()
            self._workers.append(p)
            self._index_qs.append(iq)
            self._result_qs.append(rq)
            self._free_qs.append(fq)

    def _feed_epoch(self):
        """Hand out this epoch's batches round-robin and close the epoch
        with one marker a worker (the sampler is listed anew each epoch,
        so a shuffle reshuffles)."""
        batches = list(self._loader.batch_sampler)
        self._total = len(batches)
        for bid, idxs in enumerate(batches):
            self._index_qs[bid % self._W].put((bid, idxs))
        for iq in self._index_qs:
            iq.put("epoch_end")

    def alive(self):
        return bool(self._workers) and all(p.is_alive()
                                           for p in self._workers)

    def _read_one(self, w):
        timeout = self._loader.timeout or self.DEFAULT_READ_TIMEOUT
        try:
            msg = self._result_qs[w].get(timeout=timeout)
        except queue.Empty:
            self.close()
            raise RuntimeError(
                f"DataLoader worker {w} timed out after {timeout}s (a stuck "
                "__getitem__ or collate_fn, or a worker forked while a lock "
                "was held; DataLoader(timeout=...) sets the limit)") from None
        kind = msg[0]
        if kind == "err":
            self.close()
            raise RuntimeError(f"DataLoader worker {w} failed:\n{msg[1]}")
        if kind == "end":
            return None
        _, bid, slot_idx, name, skeleton, specs = msg
        self._slot_names[(w, slot_idx)] = name
        end = max((off + int(np.prod(shape)) * np.dtype(dt).itemsize)
                  for shape, dt, off in specs) if specs else 0
        raw = _read_segment(name, end)
        self._free_qs[w].put(slot_idx)  # the slot back to its worker
        arrays = [np.frombuffer(raw, dtype=np.dtype(dt), count=int(np.prod(
            shape)), offset=off).reshape(shape) for shape, dt, off in specs]
        return _decode(skeleton, arrays)

    def __iter__(self):
        completed = False
        try:
            if self._iterable:
                live = list(range(self._W))
                while live:
                    for w in list(live):
                        out = self._read_one(w)
                        if out is None:
                            live.remove(w)
                        else:
                            yield out
            else:
                self._feed_epoch()
                for bid in range(self._total):
                    out = self._read_one(bid % self._W)
                    if out is None:
                        raise RuntimeError(
                            "DataLoader worker ended before its batches")
                    yield out
                # read each worker's epoch marker, so the next epoch's
                # reads start framed
                for w in range(self._W):
                    if self._read_one(w) is not None:
                        raise RuntimeError(
                            "DataLoader worker out of step with the epoch")
                completed = True
        finally:
            # persistent workers outlive an epoch read to its end; an
            # abandoned one leaves batches in flight, so they stop
            if not (self._persistent and completed):
                self.close()

    def close(self):
        # the workers stop at their next item and unlink their segments at
        # once; every slot goes back, so none stays blocked on the ring
        self._stop.set()
        for iq, fq in zip(self._index_qs, self._free_qs):
            try:
                iq.put_nowait(None)
                for i in range(self._n_slots):
                    fq.put_nowait(i)
            except (ValueError, OSError):
                pass
        dirty = set()
        for w, p in enumerate(self._workers):
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
                dirty.add(w)
            elif p.exitcode not in (0, None):
                dirty.add(w)
        # a worker that exited cleanly unlinked its own slots; sweep up
        # after the ones that were terminated or crashed
        for (w, _), name in self._slot_names.items():
            if w not in dirty:
                continue
            try:
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
            except (OSError, ValueError):
                pass
        self._workers = []
