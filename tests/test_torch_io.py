"""``paddle_tpu_torch.io`` against the JAX package's ``paddle_tpu.io``, on
the CPU: every dataset and sampler, the batch order under one
``np.random.seed``, ``default_collate_fn``, and the ``DataLoader`` on each
of its paths (inline, the background thread, worker processes, the C++
batcher), with a custom collate, worker errors, worker info, timeouts,
slot growth and persistent workers (the cases of
``tests/test_io_workers.py`` that apply to the port).

Every sampler draws from numpy's global ``np.random``, so both packages
are given the same seed and must give the same indices exactly; batch
values are compared exactly too (the loaders copy and stack, they do not
compute). R10: the reference's workers do not reseed ``np.random`` after
the fork, so two workers draw the same numbers; the port reproduces it.
"""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import native_batcher
from paddle_tpu_torch.core import device as tdevice


@pytest.fixture(autouse=True)
def loaders_on_the_cpu():
    """The port's loaders hand out batches on the device ``set_device``
    names (default the card): the CPU here, restored after each test."""
    prev = tdevice._state["device"]
    tdevice._state["device"] = torch.device("cpu")
    yield
    tdevice._state["device"] = prev


def _np(x):
    """A batch leaf of either package as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same(a, b):
    """Exact equality of two collated structures (reference vs port)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not hasattr(a, "numpy"):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _datasets(io):
    """The same small datasets built on either package's ``Dataset``."""

    class Square(io.Dataset):
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return np.float32(i), np.int64(i * i)

    class Vec(io.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return (np.arange(4, dtype=np.float32) + i,
                    np.asarray(i % 3, np.int64))

    class Stream(io.IterableDataset):
        def __iter__(self):
            wi = io.get_worker_info()
            wid = 0 if wi is None else wi.id
            for k in range(6):
                yield np.int64(wid * 100 + k)

    return Square, Vec, Stream


JSquare, JVec, JStream = _datasets(jio)
TSquare, TVec, TStream = _datasets(tio)


def test_map_style_datasets_match_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    jt, tt = jio.TensorDataset([a, b]), tio.TensorDataset([a, b])
    assert len(jt) == len(tt) == 6
    for i in range(6):
        _same(jt[i], tt[i])
    jc = jio.ComposeDataset([JVec(), JSquare()])
    tc = tio.ComposeDataset([TVec(), TSquare()])
    assert len(jc) == len(tc) == 10
    for i in range(10):
        _same(jc[i], tc[i])
    jcat = jio.ConcatDataset([JVec(), JSquare()])
    tcat = tio.ConcatDataset([TVec(), TSquare()])
    assert len(jcat) == len(tcat) == 33
    for i in list(range(33)) + [-1, -14, -33]:
        _same(jcat[i], tcat[i])
    js, ts = jio.Subset(JSquare(), [5, 1, 7]), tio.Subset(TSquare(), [5, 1, 7])
    assert [js[i] for i in range(3)] == [ts[i] for i in range(3)]


def test_iterable_datasets_match_reference():
    jch = jio.ChainDataset([JStream(), JStream()])
    tch = tio.ChainDataset([TStream(), TStream()])
    assert [v for v in jch] == [v for v in tch]
    with pytest.raises(RuntimeError):
        TStream()[0]
    with pytest.raises(RuntimeError):
        len(TStream())


@pytest.mark.parametrize("lengths", [[10, 8, 5], [0.5, 0.3, 0.2]])
def test_random_split_matches_reference(lengths):
    np.random.seed(11)
    jparts = jio.random_split(JSquare(), lengths)
    np.random.seed(11)
    tparts = tio.random_split(TSquare(), lengths)
    assert [p.indices for p in jparts] == [p.indices for p in tparts]


@pytest.mark.parametrize("case", ["sequence", "random", "random_replace",
                                  "random_num_samples", "weighted",
                                  "weighted_no_replace"])
def test_samplers_match_reference(case):
    def build(io, ds):
        return {
            "sequence": lambda: io.SequenceSampler(ds),
            "random": lambda: io.RandomSampler(ds),
            "random_replace": lambda: io.RandomSampler(
                ds, replacement=True, num_samples=40),
            "random_num_samples": lambda: io.RandomSampler(
                ds, num_samples=7),
            "weighted": lambda: io.WeightedRandomSampler(
                np.arange(1, 24, dtype=np.float64), 30),
            "weighted_no_replace": lambda: io.WeightedRandomSampler(
                np.arange(1, 24, dtype=np.float64), 12, replacement=False),
        }[case]()

    js, ts = build(jio, JSquare()), build(tio, TSquare())
    np.random.seed(5)
    jl = [list(js) for _ in range(2)]
    np.random.seed(5)
    tl = [list(ts) for _ in range(2)]
    assert jl == tl
    assert len(js) == len(ts)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_matches_reference(shuffle, drop_last):
    jb = jio.BatchSampler(JSquare(), shuffle=shuffle, batch_size=5,
                          drop_last=drop_last)
    tb = tio.BatchSampler(TSquare(), shuffle=shuffle, batch_size=5,
                          drop_last=drop_last)
    np.random.seed(2)
    jl = list(jb)
    np.random.seed(2)
    assert list(tb) == jl
    assert len(tb) == len(jb) == len(jl)
    custom = tio.BatchSampler(sampler=tio.SequenceSampler(TSquare()),
                              batch_size=4)
    assert list(custom)[-1] == [20, 21, 22]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_reference(shuffle, drop_last):
    for rank in range(3):
        jb = jio.DistributedBatchSampler(JSquare(), 4, num_replicas=3,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        tb = tio.DistributedBatchSampler(TSquare(), 4, num_replicas=3,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        for epoch in (0, 3):
            jb.set_epoch(epoch)
            tb.set_epoch(epoch)
            assert list(tb) == list(jb)
        assert len(tb) == len(jb)


def test_distributed_batch_sampler_defaults_without_a_process_group():
    assert not torch.distributed.is_initialized()
    tb = tio.DistributedBatchSampler(TSquare(), 4)
    assert (tb.nranks, tb.local_rank) == (1, 0)
    assert [i for b in tb for i in b] == list(range(23))


@pytest.mark.parametrize("kind", ["array", "int", "float", "tuple", "dict",
                                  "nested", "tensor", "other"])
def test_default_collate_matches_reference(kind):
    rng = np.random.RandomState(0)
    samples = {
        "array": [rng.rand(3, 2).astype(np.float32) for _ in range(4)],
        "int": [1, 5, np.int64(7), 2],
        "float": [0.5, np.float32(1.5), 2.25, 3.0],
        "tuple": [(rng.rand(2).astype(np.float32), np.int64(i))
                  for i in range(3)],
        "dict": [{"x": rng.rand(2).astype(np.float32), "y": i}
                 for i in range(3)],
        "nested": [[{"a": np.full(2, i, np.int32)}, 1.0 * i]
                   for i in range(3)],
        "tensor": [np.full((2,), i, np.float32) for i in range(3)],
        "other": ["a", "b"],
    }[kind]
    if kind == "tensor":
        import paddle_tpu
        want = jio.default_collate_fn([paddle_tpu.to_tensor(s)
                                       for s in samples])
        got = tio.default_collate_fn([torch.from_numpy(s) for s in samples])
    else:
        want = jio.default_collate_fn(samples)
        got = tio.default_collate_fn(samples)
    if kind == "other":
        assert got == want == samples
        return
    _same(want, got)
    leaves = got if isinstance(got, list) else [got]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu"


LOADER_CASES = {
    "inline": dict(num_workers=0, use_buffer_reader=False),
    "thread": dict(num_workers=0),
    "workers": dict(num_workers=2),
    "workers_drop_last": dict(num_workers=3, drop_last=True),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_order_and_content_match_reference(case, shuffle):
    kw = LOADER_CASES[case]
    np.random.seed(9)
    want = list(jio.DataLoader(JVec(), batch_size=4, shuffle=shuffle, **kw))
    np.random.seed(9)
    got = list(tio.DataLoader(TVec(), batch_size=4, shuffle=shuffle, **kw))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _same(w, g)


class _Arrays:
    """A dataset of whole arrays (``get_arrays``), as MNIST is."""

    def __init__(self, base):
        rng = np.random.RandomState(4)
        self.x = rng.rand(37, 3, 5).astype(np.float32)
        self.y = rng.randint(0, 9, 37).astype(np.int64)
        self.base = base

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def get_arrays(self):
        return self.x, self.y


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_native_batcher_path_matches_reference_and_python(num_workers,
                                                          drop_last):
    jds = type("JArrays", (_Arrays, jio.Dataset), {})(None)
    tds = type("TArrays", (_Arrays, tio.Dataset), {})(None)
    np.random.seed(1)
    want = list(jio.DataLoader(jds, batch_size=8, shuffle=True,
                               drop_last=drop_last, num_workers=num_workers))
    native_batcher.reset_batch_count()
    np.random.seed(1)
    got = list(tio.DataLoader(tds, batch_size=8, shuffle=True,
                              drop_last=drop_last, num_workers=num_workers))
    assert native_batcher.batch_count() == len(got) == len(want)
    for w, g in zip(want, got):
        _same(w, g)
    # the Python path (a custom collate keeps it off the batcher) agrees
    np.random.seed(1)
    py = list(tio.DataLoader(tds, batch_size=8, shuffle=True,
                             drop_last=drop_last,
                             collate_fn=lambda b: tio.default_collate_fn(b)))
    assert native_batcher.batch_count() == len(got)
    for g, p in zip(got, py):
        _same(g, p)


def test_native_batcher_builds_into_the_port_build_dir():
    lib = native_batcher.load()
    path = native_batcher._lib_path()
    assert path.exists() and path.parent == native_batcher.BUILD_DIR
    assert path.parent.parts[-3:] == ("paddle_tpu_torch", "csrc", "build")
    assert lib.bt_next.restype is not None


def test_a_failed_batcher_build_falls_back_only_without_a_card(monkeypatch):
    """Without a card the loader batches in Python when the library cannot
    be built, as the reference does; with one, the build error raises."""
    monkeypatch.setattr(native_batcher, "_lib", None)
    monkeypatch.setattr(native_batcher, "_error",
                        RuntimeError("no C++ compiler"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert native_batcher.supported() is False
    tds = type("TArrays", (_Arrays, tio.Dataset), {})(None)
    native_batcher.reset_batch_count()
    got = list(tio.DataLoader(tds, batch_size=8))
    want = list(tio.DataLoader(tds, batch_size=8,
                               collate_fn=lambda b: tio.default_collate_fn(b)))
    assert native_batcher.batch_count() == 0 and len(got) == 5
    for g, w in zip(got, want):
        _same(w, g)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_batcher.supported()


def test_native_batcher_refuses_bad_indices():
    x = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="non-negative"):
        native_batcher.NativeBatcher([x], [0, -1], 2)
    with pytest.raises(ValueError, match="out of range"):
        native_batcher.NativeBatcher([x], [0, 4], 2)


def test_custom_collate_in_workers_matches_reference():
    def collate(batch):
        xs = np.stack([b[0] for b in batch])
        return {"x": xs, "meta": [int(b[1]) for b in batch],
                "pair": (xs.sum(), "tag")}

    want = list(jio.DataLoader(JSquare(), batch_size=4, num_workers=2,
                               collate_fn=collate, drop_last=True))
    got = list(tio.DataLoader(TSquare(), batch_size=4, num_workers=2,
                              collate_fn=collate, drop_last=True))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        assert isinstance(g["x"], np.ndarray)     # custom collate: raw numpy
        np.testing.assert_array_equal(w["x"], g["x"])
        assert w["meta"] == g["meta"] and w["pair"][1] == g["pair"][1]
        assert float(w["pair"][0]) == float(g["pair"][0])


class _Pid(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        wi = tio.get_worker_info()
        return (np.int64(os.getpid()), np.int64(-1 if wi is None else wi.id),
                np.int64(i))


def test_workers_are_processes_with_worker_info():
    pids, wids = set(), set()
    for pid, wid, _ in tio.DataLoader(_Pid(), batch_size=2, num_workers=2):
        pids.update(pid.tolist())
        wids.update(wid.tolist())
    assert os.getpid() not in pids and len(pids) == 2
    assert wids == {0, 1}
    assert tio.get_worker_info() is None


def test_persistent_workers_survive_epochs():
    dl = tio.DataLoader(_Pid(), batch_size=2, num_workers=2,
                        persistent_workers=True)
    try:
        seen = []
        for _ in range(3):
            seen.append({p for pid, _, _ in dl for p in pid.tolist()})
        assert seen[0] == seen[1] == seen[2] and len(seen[0]) == 2
    finally:
        dl._mp_iter.close()


class _Bad(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("poisoned sample 5")
        return np.float32(i)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataset_error_reaches_the_caller(num_workers):
    dl = tio.DataLoader(_Bad(), batch_size=4, num_workers=num_workers)
    err = RuntimeError if num_workers else ValueError
    with pytest.raises(err, match="poisoned sample 5"):
        list(dl)


def test_worker_init_fn_runs_in_the_worker():
    class Env(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.int64(int(os.environ.get("_PDTPU_TORCH_WID", -1)))

    def init(wid):
        os.environ["_PDTPU_TORCH_WID"] = str(wid)

    seen = {v for b in tio.DataLoader(Env(), batch_size=2, num_workers=2,
                                      worker_init_fn=init)
            for v in b.tolist()}
    assert seen and seen <= {0, 1}
    assert "_PDTPU_TORCH_WID" not in os.environ


def test_iterable_dataset_in_workers_matches_reference():
    want = sorted(int(v) for b in jio.DataLoader(JStream(), batch_size=3,
                                                 num_workers=2)
                  for v in b.numpy())
    got = sorted(int(v) for b in tio.DataLoader(TStream(), batch_size=3,
                                                num_workers=2)
                 for v in b.tolist())
    assert got == want == sorted(w * 100 + k for w in (0, 1)
                                 for k in range(6))


def test_large_batches_grow_the_ring_slot():
    class Big(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.full((512, 1024), i, np.float32)   # 2 MB > 1 MB slot

    out = list(tio.DataLoader(Big(), batch_size=2, num_workers=2))
    assert [tuple(b.shape) for b in out] == [(2, 512, 1024)] * 2
    assert [b[:, 0, 0].tolist() for b in out] == [[0, 1], [2, 3]]


def test_batches_own_their_memory_after_the_slot_returns():
    out = list(tio.DataLoader(TVec(), batch_size=2, num_workers=2,
                              prefetch_factor=2))
    want = list(tio.DataLoader(TVec(), batch_size=2,
                               use_buffer_reader=False))
    for g, w in zip(out, want):
        _same(w, g)


def test_worker_timeout_raises():
    class Slow(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                time.sleep(30)
            return np.float32(i)

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        list(tio.DataLoader(Slow(), batch_size=2, num_workers=2, timeout=2))
    assert time.monotonic() - t0 < 20


def test_cpu_tensors_pass_and_device_tensors_raise_in_workers():
    from paddle_tpu_torch.io.worker import _tensor_to_np

    class Tensors(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return torch.tensor(float(i))

    out = list(tio.DataLoader(Tensors(), batch_size=2, num_workers=2))
    assert [b.tolist() for b in out] == [[0.0, 1.0], [2.0, 3.0]]
    with pytest.raises(RuntimeError, match="CPU tensors"):
        _tensor_to_np(torch.empty(2, device="meta"))


def test_abandoned_iteration_stops_the_workers_and_frees_their_slots():
    import glob

    before = set(glob.glob("/dev/shm/pdtpu_torch_*"))
    dl = tio.DataLoader(TSquare(), batch_size=2, num_workers=2)
    it = iter(dl)
    next(it)
    t0 = time.monotonic()
    it.close()
    # the workers stop at once; a worker left blocked on the ring would be
    # joined for 5 s and then killed
    assert time.monotonic() - t0 < 8
    assert set(glob.glob("/dev/shm/pdtpu_torch_*")) <= before
    it2 = iter(tio.DataLoader(TSquare(), batch_size=2))
    next(it2)
    it2.close()


class _Draws:
    """Samples that are random draws from numpy's global generator, as a
    random transform makes them."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.random.rand(3).astype(np.float32)


def test_r10_workers_repeat_each_others_random_draws_as_the_reference():
    """R10: forked from one parent state and never reseeded, worker 0 and
    worker 1 draw the same numbers, so batch 0 (worker 0) equals batch 1
    (worker 1); the reference does the same."""
    jds = type("JDraws", (_Draws, jio.Dataset), {})()
    tds = type("TDraws", (_Draws, tio.Dataset), {})()
    np.random.seed(21)
    want = [b.numpy() for b in jio.DataLoader(jds, batch_size=2,
                                              num_workers=2)]
    np.random.seed(21)
    got = [b.numpy() for b in tio.DataLoader(tds, batch_size=2,
                                             num_workers=2)]
    np.testing.assert_array_equal(want[0], want[1])
    np.testing.assert_array_equal(want[2], want[3])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
