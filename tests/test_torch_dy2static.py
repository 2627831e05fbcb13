"""dy2static in the port (paddle_tpu_torch.jit.dy2static) against the JAX
package, on the CPU: Python if / while / for over tensor values compile to
ONE graph through ``torch.cond`` / ``while_loop`` (``fullgraph=True``: no
graph break, no eager run).

Each case of the reference's ``tests/test_dy2static.py`` is one test: the
same function goes through the JAX package's ``to_static`` and the port's,
on the same inputs, and the values agree (f32, rtol 1e-6; the loops'
counts exactly). The port compiles with the ``aot_eager`` backend here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.jit.dy2static import (UnsupportedSyntax,
                                            transform_function)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    prev = tdevice._state["device"]
    paddle.set_device("cpu")
    yield
    tdevice._state["device"] = prev


# each case: (builder of the function over a package P, inputs per call)

def early_return(P):
    def f(x):
        if x.sum() > 0:
            return x * 2
        return x - 1
    return f, [[1.0, 1.0, 1.0]], [[-1.0, -1.0, -1.0]]


def assignment_branches(P):
    def f(x):
        if P.mean(x) > 1.0:
            y = x * 10
        else:
            y = x / 10
        return y + 1
    return f, [[2.0, 4.0]], [[0.0, 1.0]]


def elif_chain(P):
    def f(x):
        s = x.sum()
        if s > 10:
            r = x * 0
        elif s > 0:
            r = x + 100
        else:
            r = -x
        return r
    return f, [[20.0]], [[5.0]], [[-3.0]]


def ternary_ifexp(P):
    def f(x):
        y = x * 2 if x.max() > 0 else x * 3
        return y
    return f, [[1.0]], [[-1.0]]


def bool_ops_on_tensors(P):
    def f(x):
        if (x.sum() > 0) and (x.max() < 10):
            return x + 1
        return x - 1
    return f, [[1.0, 2.0]], [[20.0, 1.0]]


def data_dependent_while(P):
    def f(x):
        while P.max(P.abs(x)) > 1.0:
            x = x / 2
        return x
    return f, [[8.0, 4.0]], [[0.5, 0.25]]


def while_with_body_temp(P):
    def f(x):
        s = P.zeros([])
        while s < x.sum():
            t = s + 1.0
            s = t * 1.5
        return s
    return f, [[4.0]], [[0.5]]


def for_range_traced_bound(P):
    def f(x, n):
        acc = P.zeros_like(x)
        for i in range(n):
            acc = acc + x
        return acc
    return f, ([1.0, 2.0], np.int64(3)), ([0.5, 1.0], np.int64(0))


def concrete_for_with_traced_break(P):
    def f(x):
        acc = 0.0
        for v in [1.0, 2.0]:
            if x.sum() > v:
                break
            acc = acc + v
        return x + acc
    return f, [[10.0]], [[-10.0]], [[1.5]]


def concrete_for_traced_continue_and_return(P):
    def f(x):
        acc = x * 0.0
        for v in [1.0, 2.0, 3.0]:
            if x.sum() > 0 and v == 2.0:
                continue
            if x.sum() > 100:
                return acc - 1.0
            acc = acc + v
        return acc
    return f, [[1.0]], [[-1.0]], [[200.0]]


def nested_structure_loop_var_alignment(P):
    def f(x):
        pair = (x, x * 2)
        s = P.zeros([])
        while s < x.sum():
            z = pair[0].sum()
            s = s + z + 1.0
        return s
    return f, [[2.0]], [[0.25]]


def break_in_while(P):
    def f(x):
        s = P.zeros([])
        i = P.zeros([])
        while i < 10:
            s = s + x.sum()
            if s > 5:
                break
            i = i + 1
        return s + i
    return f, [[2.0]], [[0.4]]


def continue_in_for_range(P):
    def f(x):
        s = P.zeros([])
        for i in range(6):
            if x.sum() + i < 3:
                continue
            s = s + i
        return s
    return f, [[0.0]], [[2.5]], [[-10.0]]


def break_skips_rest_of_body(P):
    def f(x):
        hits = P.zeros([])
        i = P.zeros([])
        while i < 5:
            if i >= x.sum():
                break
            hits = hits + 1
            i = i + 1
        return hits
    return f, [[3.0]], [[0.0]]


def return_in_while(P):
    def f(x):
        i = P.zeros([])
        acc = x * 0
        while i < 8:
            acc = acc + x
            if acc.sum() > 4:
                return acc * 10
            i = i + 1
        return acc
    return f, [[3.0]], [[0.1]]


def return_in_for_range(P):
    def f(x):
        for i in range(10):
            if x.sum() < i:
                return x * i
        return x - 1
    return f, [[2.5]], [[100.0]]


def return_from_nested_loop(P):
    def f(x):
        s = P.zeros([])
        for i in range(3):
            for j in range(3):
                s = s + x.sum()
                if s > 4:
                    return s * 100
        return s
    return f, [[1.0]], [[0.3]]


def continue_then_break_mixed(P):
    def f(x):
        s = P.zeros([])
        for i in range(8):
            if i < x.sum():
                continue
            if i > x.sum() + 3:
                break
            s = s + i
        return s
    return f, [[2.0]], [[0.0]], [[9.0]]


def return_from_nested_loop_traced_outer_cond(P):
    def f(x):
        s = P.zeros([])
        i = P.zeros([])
        while i < x.sum() + 3:
            j = P.zeros([])
            while j < 2:
                s = s + x.sum()
                if s > 4:
                    return s * 100
                j = j + 1
            i = i + 1
        return s
    return f, [[2.0]], [[0.5]]


def tuple_return_in_compiled_loop(P):
    def f(x):
        i = P.zeros([])
        while i < 8:
            if x.sum() > 4:
                return x, i
            i = i + 1
        return x * 0.0, i
    return f, [[10.0]], [[1.0]]


def concrete_for_break_freezes_loop_variable(P):
    def f(x):
        v = 0.0
        for v in [1.0, 2.0, 3.0]:
            if x.sum() > 0:
                break
        return x + v
    return f, [[5.0]], [[-5.0]]


CASES = [early_return, assignment_branches, elif_chain, ternary_ifexp,
         bool_ops_on_tensors, data_dependent_while, while_with_body_temp,
         for_range_traced_bound, concrete_for_with_traced_break,
         concrete_for_traced_continue_and_return,
         nested_structure_loop_var_alignment, break_in_while,
         continue_in_for_range, break_skips_rest_of_body, return_in_while,
         return_in_for_range, return_from_nested_loop,
         continue_then_break_mixed,
         return_from_nested_loop_traced_outer_cond,
         tuple_return_in_compiled_loop,
         concrete_for_break_freezes_loop_variable]


def _args(P, call):
    call = call if isinstance(call, tuple) else (call,)
    conv = paddle_tpu.to_tensor if P is paddle_tpu else torch.as_tensor
    return [conv(np.asarray(a, np.float32) if isinstance(a, list) else a)
            for a in call]


def _numpy(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o.numpy()) for o in out]
    return [np.asarray(out.numpy())]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_case_compiles_to_one_program_and_matches_reference(case):
    rf, *calls = case(paddle_tpu)
    tf_, *_ = case(paddle)
    rs, ts = paddle_tpu.jit.to_static(rf), jit.to_static(tf_)
    for call in calls:
        want = _numpy(rs(*_args(paddle_tpu, call)))
        got = _numpy(ts(*_args(paddle, call)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert "eager" not in ts._cache.values()
    assert len(ts.concrete_programs) == 1
    assert ts._needs_transform


class Net(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(4, 4)

    def forward(self, x):
        y = self.fc(x)
        if paddle.mean(y) > 0:
            y = y * 2
        else:
            y = y - 1
        while paddle.max(paddle.abs(y)) > 1.0:
            y = y / 2
        return y


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 4)

    def forward(self, x):
        y = self.fc(x)
        if paddle_tpu.mean(y) > 0:
            y = y * 2
        else:
            y = y - 1
        while paddle_tpu.max(paddle_tpu.abs(y)) > 1.0:
            y = y / 2
        return y


def test_layer_with_loop_and_branch_compiles_to_one_program():
    paddle_tpu.seed(3)
    jn = JNet()
    tn = Net()
    tn.set_state_dict({k: np.asarray(v._value)
                       for k, v in jn.state_dict().items()})
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    want = paddle_tpu.jit.to_static(jn)(paddle_tpu.to_tensor(x)).numpy()
    st = jit.to_static(tn)
    got = st(paddle.to_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               st._orig_forward(paddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    sf = st.forward_static
    assert "eager" not in sf._cache.values() and len(sf._cache) == 1


def test_strict_default_raises_on_unsupported():
    @jit.to_static
    def f(x):
        while x.sum() > 0:
            with open("/dev/null"):
                break
        return x

    with pytest.raises(RuntimeError, match="fallback=True"):
        f(torch.tensor([10.0]))


def test_explicit_fallback_warns_and_runs():
    @jit.to_static(fallback=True)
    def f(x):
        acc = 0.0
        while x.sum() > acc:
            with open("/dev/null"):
                break
        return x + acc

    with pytest.warns(UserWarning, match="running eagerly"):
        out = f(torch.tensor([10.0]))
    np.testing.assert_allclose(out.numpy(), [10.0])
    out2 = f(torch.tensor([-10.0]))          # cached eager: no new warning
    np.testing.assert_allclose(out2.numpy(), [-10.0])


def test_fallback_flag_and_runtime_diagnostics():
    """The flag opts in like fallback=True, and the fallback also covers the
    conversion runtime's own diagnostics (a one-branch assignment)."""
    @jit.to_static
    def f(x):
        if x.sum() > 0:
            y = x * 2  # noqa: F841 (assigned in one branch only)
        return x + 1

    with pytest.raises(RuntimeError, match="only one branch"):
        f(torch.tensor([1.0]))
    paddle.set_flags({"FLAGS_dy2static_eager_fallback": True})
    try:
        with pytest.warns(UserWarning, match="running eagerly"):
            out = f(torch.tensor([1.0]))
    finally:
        paddle.set_flags({"FLAGS_dy2static_eager_fallback": False})
    np.testing.assert_allclose(out.numpy(), [2.0])


def test_branch_shape_mismatch_is_diagnosed():
    @jit.to_static
    def f(x):
        if x.sum() > 0:
            y = x[:1]
        else:
            y = x
        return y

    with pytest.raises(RuntimeError, match="different shapes"):
        f(torch.tensor([1.0, 2.0]))


# -- the transform on its own --------------------------------------------------

def test_concrete_control_flow_keeps_python_semantics():
    def f(n):
        total = 0
        for i in range(n):
            if i % 2 == 0:
                total = total + i
        return total

    assert transform_function(f)(10) == f(10) == 20


def test_closure_capture():
    scale = 3.0

    def f(x):
        if x > 0:
            y = x * scale
        else:
            y = -x * scale
        return y

    g = transform_function(f)
    assert g(2.0) == 6.0 and g(-2.0) == 6.0


def test_assert_statement():
    def f(x):
        assert x > 0, "need positive"
        return x + 1

    g = transform_function(f)
    assert g(1) == 2
    with pytest.raises(AssertionError, match="need positive"):
        g(-1)


def test_concrete_args_keep_python_semantics():
    def f(n):
        s = 0
        for i in range(10):
            if i >= n:
                break
            s = s + i
        return s

    g = transform_function(f)
    for n in (0, 3, 10, 15):
        assert g(n) == f(n)


@pytest.mark.parametrize("which", ["side_store", "bare_return", "reserved"])
def test_unsupported_syntax_is_refused(which):
    holder = {}

    def side_store(x):
        if x.sum() > 0:
            holder["k"] = x
            return x * 2
        return x - 1

    def bare_return(x):
        i = paddle.zeros([])
        while i < 8:
            if x.sum() > 4:
                return
            i = i + 1
        return i

    def reserved(x):
        _pd_ctl_retv_1 = x * 2
        return _pd_ctl_retv_1

    match = {"side_store": "mutation", "bare_return": "bare",
             "reserved": "reserved"}[which]
    with pytest.raises(UnsupportedSyntax, match=match):
        transform_function(locals()[which])
