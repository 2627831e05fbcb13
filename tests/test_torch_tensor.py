"""The port's ``Tensor`` (paddle_tpu_torch.core.tensor) against the JAX
package's: the cases of ``tests/test_tensor.py`` through both packages,
then the names Paddle's and torch's tensors share, in both forms.

``Tensor.dtype`` is a ``torch.dtype`` in the port and a numpy dtype in
the JAX package; both compare equal to their package's ``paddle.float32``
and map to the same Paddle name (``core.dtype.dtype_name``). Values are
compared exactly (the same numpy inputs, no arithmetic beyond exact
float32 sums).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.core.dtype import dtype_name as j_name
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core.dtype import dtype_name as t_name

torch.set_num_threads(2)
PKGS = [J, T]


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's entry points on the CPU for each test (restored after)."""
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _name(pkg, t):
    return j_name(t.dtype) if pkg is J else t_name(t.dtype)


@pytest.mark.parametrize("data,dtype,want", [
    ([1.0, 2.0, 3.0], None, "float32"),
    (np.array([1.0, 2.0]), None, "float64"),
    ([1, 2, 3], None, "int64"),
    ([True, False], None, "bool"),
    ([1.0], "bfloat16", "bfloat16"),
    (3.5, None, "float32"),
    (7, None, "int64"),
    (np.arange(4, dtype=np.int32), None, "int32"),
])
def test_to_tensor_dtypes_as_the_reference(data, dtype, want):
    for pkg in PKGS:
        t = pkg.to_tensor(data, dtype=dtype)
        assert _name(pkg, t) == want, pkg.__name__
    assert T.to_tensor([1.0]).dtype == T.float32 == torch.float32
    assert J.to_tensor([1.0]).dtype == J.float32


def test_shape_size_ndim_len_item_numpy():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg in PKGS:
        t = pkg.to_tensor(arr)
        np.testing.assert_array_equal(t.numpy(), arr)
        assert t.shape == [2, 3] and len(t) == 2 and t.ndim == 2
        assert t.size == 6
        assert pkg.to_tensor(3.5).item() == pytest.approx(3.5)


def test_astype_cast():
    for pkg in PKGS:
        ti = pkg.to_tensor([1.5, 2.5]).astype("int32")
        assert _name(pkg, ti) == "int32"
        np.testing.assert_array_equal(ti.numpy(), [1, 2])


def test_indexing():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = []
    for pkg in PKGS:
        t = pkg.to_tensor(arr)
        assert t[0].shape == [4] and t[1:, :2].shape == [2, 2]
        assert t[0, 1].item() == 1.0
        got.append(t[pkg.to_tensor([0, 2])].numpy())
        got.append(t[[2, 0]].numpy())
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_array_equal(got[1], got[3])
    np.testing.assert_array_equal(got[0], arr[[0, 2]])
    assert type(T.to_tensor(arr)[0]) is T.Tensor


def test_setitem():
    for pkg in PKGS:
        t = pkg.to_tensor(np.zeros((3, 3), np.float32))
        t[1] = 5.0
        assert t.numpy()[1].tolist() == [5.0, 5.0, 5.0]
        t[0, 0] = pkg.to_tensor(2.0)
        assert t[0, 0].item() == 2.0


def test_arithmetic_dunders():
    outs = {}
    for pkg in PKGS:
        a = pkg.to_tensor([1.0, 2.0])
        b = pkg.to_tensor([3.0, 4.0])
        i = pkg.to_tensor([7, -7])
        outs[pkg] = [(a + b), (a - b), (a * b), (b / a), (a + 1), (2 * a),
                     (-a), (a ** 2), (1 - a), (2 / a), (a == a), (a < b),
                     (a @ b), (i // 2), (i % 3), (i / 2), (~(a > 1))]
    for j, t in zip(outs[J], outs[T]):
        assert type(t) is T.Tensor
        assert _name(J, j) == _name(T, t)
        np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_clone_detach():
    for pkg in PKGS:
        t = pkg.to_tensor([1.0], stop_gradient=False)
        c, d = t.clone(), t.detach()
        assert not c.stop_gradient and d.stop_gradient
        assert t.item() == 1.0


def test_set_value():
    for pkg in PKGS:
        t = pkg.to_tensor([1.0, 2.0])
        t.set_value(np.array([5.0, 6.0], np.float32))
        np.testing.assert_allclose(t.numpy(), [5, 6])
        with pytest.raises(ValueError):
            t.set_value(np.zeros(3, np.float32))


def test_parameter():
    for pkg in PKGS:
        p = pkg.Parameter(np.ones((2, 2), np.float32))
        assert not p.stop_gradient and p.persistable
        assert isinstance(p, pkg.Tensor)
    assert isinstance(T.Parameter(np.ones(2, np.float32)), torch.nn.Parameter)


def test_place_and_device():
    t = T.to_tensor([1.0])
    assert t.place == T.CPUPlace() and t.place.is_cpu_place()
    assert T.get_device() == "cpu"
    assert T.resolve_device(None).type == "cpu"
    assert T.to_tensor([1.0], place="cpu").device.type == "cpu"


def test_to_tensor_without_a_card_or_set_device_raises():
    tdevice._state["device"] = None
    if torch.cuda.is_available():
        assert T.to_tensor([1.0]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.to_tensor([1.0])
    with pytest.raises(RuntimeError):
        T.zeros([2])
    assert T.get_device() == "gpu:0"


def test_torch_ops_on_a_tensor_give_plain_tensors():
    """``__torch_function__`` is off: torch's own functions run at full
    speed and hand back plain tensors; the port's ops hand back Tensors
    for Tensors and plain tensors for plain tensors."""
    t = T.to_tensor([1.0, 2.0])
    assert type(torch.exp(t)) is torch.Tensor
    assert type(T.exp(t)) is T.Tensor
    assert type(T.exp(torch.ones(2))) is torch.Tensor
    assert type(T.zeros([2])) is T.Tensor


# -- the names Paddle's and torch's Tensor share: both forms -------------


def test_size_shape_dim_numel_both_forms():
    t = T.to_tensor(np.zeros((2, 3), np.float32))
    assert t.size == 6 and t.size() == torch.Size([2, 3]) and t.size(1) == 3
    assert t.shape == [2, 3] and t.shape == (2, 3)
    assert torch.zeros(t.shape).shape == (2, 3)
    assert t.shape[1:] == [3] and list(t.shape) + [1] == [2, 3, 1]
    assert t.dim == 2 and t.dim() == 2
    assert t.numel() == 6 and t.numel().item() == 6
    assert J.to_tensor(np.zeros((2, 3))).dim == 2


def _arr(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_transpose_reshape_expand_flatten_both_forms():
    a = _arr(2, 3, 4)
    j, t = J.to_tensor(a), T.to_tensor(a)
    for pd, tf in ((lambda x: x.transpose([2, 0, 1]),
                    lambda x: x.permute(2, 0, 1)),
                   (lambda x: x.reshape([4, 6]), lambda x: x.reshape(4, 6)),
                   (lambda x: x.flatten(start_axis=1),
                    lambda x: x.flatten(start_dim=1)),
                   (lambda x: x[:, :1].expand([2, 5, 4]),
                    lambda x: x[:, :1].expand(2, 5, 4)),
                   (lambda x: x.unsqueeze([0, 2]),
                    lambda x: x.unsqueeze(0).unsqueeze(2)),
                   (lambda x: x.squeeze(0) if x.shape[0] == 1
                    else x.unsqueeze(0).squeeze(0), lambda x: x)):
        want = pd(j).numpy()
        np.testing.assert_array_equal(pd(t).numpy(), want)
        np.testing.assert_array_equal(tf(t).numpy(), want)
    assert t.transpose(0, 2).shape == [4, 3, 2]            # torch's form
    assert t.view(6, 4).shape == [6, 4]                    # torch's form
    assert t.view([6, 4]).shape == [6, 4]                  # Paddle's form
    assert t.view("float64").dtype == torch.float64        # Paddle: a cast


def test_reductions_both_forms():
    a = _arr(3, 4, seed=1)
    j, t = J.to_tensor(a), T.to_tensor(a)
    for name in ("sum", "mean", "max", "min", "prod"):
        np.testing.assert_allclose(getattr(t, name)(axis=1).numpy(),
                                   getattr(j, name)(axis=1).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(getattr(t, name)(1).numpy(),
                                   getattr(j, name)(1).numpy(), rtol=1e-6)
    # torch's forms: keepdim positional, dim=, and max / min's tuples
    assert t.sum(1, True).shape == [3, 1]
    assert t.sum(dim=1).shape == [3]
    vals, idx = t.max(dim=1)
    np.testing.assert_array_equal(idx.numpy(), a.argmax(1))
    vals, idx = torch.max(t, 1)
    np.testing.assert_array_equal(vals.numpy(), a.max(1))
    np.testing.assert_array_equal(t.max().numpy(), a.max())


def test_sort_split_gather_scatter_both_forms():
    a = _arr(4, 3, seed=2)
    j, t = J.to_tensor(a), T.to_tensor(a)
    np.testing.assert_array_equal(t.sort(axis=0).numpy(),
                                  j.sort(axis=0).numpy())
    vals, idx = torch.sort(t, 0)                           # torch's form
    np.testing.assert_array_equal(idx.numpy(), np.argsort(a, 0, "stable"))
    assert len(t.sort(dim=0)) == 2                         # torch's form
    parts = t.split(2)                                     # Paddle: 2 parts
    assert [p.shape for p in parts] == [[2, 3], [2, 3]]
    assert [p.shape for p in j.split(2)] == [[2, 3], [2, 3]]
    assert [p.shape for p in t.split(1, dim=1)] == [(4, 1)] * 3  # torch's
    assert [p.shape for p in t.split(split_size=1)] == [(1, 3)] * 4
    # torch.split hands its int to the method positionally, where the
    # arguments cannot tell the forms apart: Paddle's (one part here);
    # sections are the same in both
    assert [p.shape for p in torch.split(t, 1)] == [(4, 3)]
    assert [p.shape for p in torch.split(t, [1, 3])] == [(1, 3), (3, 3)]
    idx = np.array([2, 0])
    np.testing.assert_array_equal(t.gather(T.to_tensor(idx), 0).numpy(),
                                  j.gather(J.to_tensor(idx), 0).numpy())
    i2 = torch.tensor([[0, 1, 2], [3, 2, 1]])
    np.testing.assert_array_equal(t.gather(0, i2).numpy(),     # torch's
                                  np.take_along_axis(a, i2.numpy(), 0))
    upd = _arr(2, 3, seed=3)
    got = t.scatter(T.to_tensor(np.array([1, 3])), T.to_tensor(upd))
    want = j.scatter(J.to_tensor(np.array([1, 3])), J.to_tensor(upd))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert t.scatter(0, i2, torch.ones(2, 3)).shape == [4, 3]  # torch's


def test_where_equal_allclose_norm_both_forms():
    a, b = _arr(2, 3, seed=4), _arr(2, 3, seed=5)
    t, u = T.to_tensor(a), T.to_tensor(b)
    # Paddle's: elementwise equal, allclose as a tensor, where(cond, x, y)
    assert t.equal(t).numpy().all() and t.equal(u).shape == [2, 3]
    assert bool(t.allclose(t).numpy())
    assert torch.equal(t, t) is True                       # torch's form
    cond = T.to_tensor(a > 0)
    np.testing.assert_array_equal(cond.where(t, u).numpy(),
                                  np.where(a > 0, a, b))
    np.testing.assert_array_equal(torch.where(cond, t, u).numpy(),
                                  np.where(a > 0, a, b))
    np.testing.assert_allclose(t.norm().numpy(), np.linalg.norm(a),
                               rtol=1e-6)
    np.testing.assert_allclose(t.norm(p=2, axis=1).numpy(),
                               t.norm(dim=1).numpy(), rtol=1e-6)


def test_torch_calls_inside_the_port_take_torch_forms():
    """The port's own code runs torch's forms: its boundaries hand it
    plain tensors (a port layer's ``forward``, ``nn.functional``), and on
    its parameters (Tensors) it calls them explicitly. A user's layer is
    handed Tensors and gets Paddle's forms. The form depends on the
    arguments only, never on the calling module's name."""
    seen = []

    class Mine(T.nn.Layer):
        def forward(self, x):
            seen.append(type(x))
            return x.split(2)                       # Paddle's: two parts

    class Port(T.nn.Linear):                        # the port's forward
        pass

    parts = T.nn.Sequential(Port(3, 4), Mine())(T.to_tensor(_arr(4, 3)))
    assert seen == [T.Tensor] and len(parts) == 2
    assert [type(p) for p in parts] == [T.Tensor] * 2
    labels = T.to_tensor(np.array([[1], [0], [2], [1]]))
    logits = T.to_tensor(_arr(4, 3, seed=7))
    loss = T.nn.functional.cross_entropy(logits, labels)   # squeeze, gather
    want = -np.log(np.exp(logits.numpy()) / np.exp(logits.numpy()).sum(
        1, keepdims=True))[np.arange(4), labels.numpy()[:, 0]].mean()
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    ns = {"__name__": "torch_utils"}
    exec("def parts(x):\n    return x.split(2)\n", ns)
    assert len(ns["parts"](T.to_tensor(_arr(4, 3)))) == 2  # Paddle's
    fc = T.nn.Linear(3, 2)
    x = T.to_tensor(_arr(4, 3, seed=6))
    out = fc(x)
    assert type(out) is T.Tensor and out.shape == [4, 2]
    np.testing.assert_allclose(out.numpy(),
                               (T.matmul(x, fc.weight) + fc.bias).numpy(),
                               rtol=1e-6)
    assert fc.weight.shape == [3, 2]
