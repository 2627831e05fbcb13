"""``paddle_tpu_torch.metric`` against the JAX package's
``paddle_tpu.metric``, on the CPU: ``Accuracy`` top-1 and top-5 (labels
``[N]`` and ``[N, 1]``, logits with ties), ``Precision``, ``Recall``,
``Auc`` and ``accuracy``, batch by batch on the same seeded numpy inputs,
given to the port as torch tensors (f32 and bf16) and as numpy arrays.

Both packages compute in numpy on the host with the same expressions, so
every result must be equal exactly; ties rank as ``np.argsort(-pred)``
ranks them. bf16 logits are compared with the reference given the same
bf16-rounded values in f32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.metric as jm

from paddle_tpu_torch import metric as tm


def _batches(seed, n=4, N=16, C=12, ties=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pred = rng.randn(N, C).astype(np.float32)
        if ties:        # a few integer levels: many equal logits a row
            pred = np.round(pred).astype(np.float32)
        out.append((pred, rng.randint(0, C, N).astype(np.int64)))
    return out


def _as(kind, a):
    if kind == "numpy":
        return a
    t = torch.from_numpy(a)
    return t.bfloat16() if kind == "bf16" and t.is_floating_point() else t


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
@pytest.mark.parametrize("label_shape", ["N", "N1"])
@pytest.mark.parametrize("kind", ["numpy", "f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_accuracy_matches_reference(topk, label_shape, kind, ties):
    ja, ta = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert ja.name() == ta.name()
    for pred, label in _batches(3, ties=ties):
        if kind == "bf16":
            pred = torch.from_numpy(pred).bfloat16().float().numpy()
        if label_shape == "N1":
            label = label[:, None]
        jc = ja.compute(paddle_tpu.to_tensor(pred),
                        paddle_tpu.to_tensor(label))
        tc = ta.compute(_as(kind, pred), _as(kind, label))
        np.testing.assert_array_equal(np.asarray(jc), tc)
        np.testing.assert_array_equal(ja.update(jc), ta.update(tc))
    assert ja.accumulate() == ta.accumulate()
    ta.reset()
    assert np.all(ta.count == 0)


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
@pytest.mark.parametrize("kind", ["numpy", "f32"])
def test_precision_and_recall_match_reference(cls, kind):
    j, t = getattr(jm, cls)(), getattr(tm, cls)()
    assert j.name() == t.name()
    assert j.accumulate() == t.accumulate() == 0.0
    rng = np.random.RandomState(7)
    for _ in range(3):
        p = rng.rand(20).astype(np.float32)
        y = rng.randint(0, 2, 20).astype(np.int64)
        j.update(p, y)
        t.update(_as(kind, p), _as(kind, y))
    assert j.accumulate() == t.accumulate()


@pytest.mark.parametrize("shape", ["1d", "2col"])
def test_auc_matches_reference(shape):
    j, t = jm.Auc(num_thresholds=255), tm.Auc(num_thresholds=255)
    assert j.accumulate() == t.accumulate() == 0.0
    rng = np.random.RandomState(8)
    for _ in range(3):
        p = rng.rand(50).astype(np.float32)
        y = (rng.rand(50) < p).astype(np.int64)
        if shape == "2col":
            p = np.stack([1 - p, p], 1)
        j.update(p, y)
        t.update(torch.from_numpy(p), torch.from_numpy(y))
    assert j.accumulate() == t.accumulate()
    assert 0.5 < t.accumulate() <= 1.0


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_accuracy_function_matches_reference(k, ties):
    for pred, label in _batches(9, n=2, ties=ties):
        want = jm.accuracy(paddle_tpu.to_tensor(pred),
                           paddle_tpu.to_tensor(label[:, None]), k=k)
        got = tm.accuracy(torch.from_numpy(pred),
                          torch.from_numpy(label[:, None]), k=k)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(np.asarray(want.numpy())) == got.item()


def test_metric_base_matches_reference():
    assert tm.Metric().name() == jm.Metric().name() == "metric"
    assert tm.Metric(name="x").compute(1, 2) == (1, 2)
    for meth in ("reset", "update", "accumulate"):
        with pytest.raises(NotImplementedError):
            getattr(tm.Metric(), meth)()
