"""The port's op library (``paddle_tpu_torch.ops``: creation, math,
manipulation, linalg, logic, search, stat, fused) against the JAX
package's ops of the same names, one case per op.

Inputs are seeded float64 arrays (``tools/eager_op_cases.py``: its
structured cases, ``tests/test_op_grads.py``'s ``SPECS`` among them, else
a generic unary-then-binary probe), handed to both packages as tensors. Values must
agree within rtol 1e-9 / atol 1e-12 (both run f64; the decompositions'
LAPACKs and the special functions' series differ in the last bits, so
those ops take 1e-7). For every op outside ``test_op_grads.WHITELIST``
(whose reasons hold here too: integer or bool outputs, creation,
randomness, data-dependent shapes, host-side implementations) the
gradients of ``sum(out_i * w_i)`` under a fixed seeded cotangent ``w``
with respect to every float64 input must agree within rtol 1e-7 / atol
1e-10 (``TOLS``'s looser rtols for the decompositions). The random ops
agree in distribution only (ROADMAP's sampling contract): moments,
shapes, dtypes and determinism under ``paddle.seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.ops as JO
import paddle_tpu_torch as T
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests import test_op_grads as G
from tools.eager_op_cases import LOOSE, SIGNED, cases

torch.set_num_threads(1)
MODULES = ("creation", "math", "manipulation", "linalg", "logic", "search",
           "stat", "fused")
SKIP = {"to_tensor": "a constructor: test_torch_tensor.py",
        "create_parameter": "a constructor: test_create_parameter below",
        "is_tensor": "a type check: test_is_tensor below"}
RANDOM = set(TO.random.__all__) | {"log_normal"}


def _names(modules=MODULES):
    names = set()
    for m in modules:
        names.update(getattr(TO, m).__all__)
    return sorted(names - set(SKIP) - RANDOM)


# this file's share of the ops; tests/test_torch_ops_linalg.py has the rest
HERE = ("creation", "math", "logic", "stat", "fused")


def _cases(name):
    def probe(args, kwargs):
        try:
            return bool(_outs(_jfn(name)(*_convert(J, args), **kwargs)))
        except Exception:
            return False

    return cases(name, probe)


def _jfn(name):
    for m in MODULES:
        mod = getattr(JO, m)
        if name in mod.__all__:
            return getattr(mod, name)
    raise KeyError(name)


def _tfn(name):
    for m in MODULES:
        mod = getattr(TO, m)
        if name in mod.__all__:
            return getattr(mod, name)
    raise KeyError(name)


def _convert(P, args, grad=False):
    """numpy arrays (also inside one level of lists / tuples) as ``P``'s
    tensors; float64 ones require grad when ``grad``."""
    def one(a):
        if isinstance(a, np.ndarray):
            return P.to_tensor(a, stop_gradient=not (
                grad and a.dtype == np.float64))
        return a

    out = []
    for a in args:
        if isinstance(a, (list, tuple)) and any(
                isinstance(e, np.ndarray) for e in a):
            out.append(type(a)(one(e) for e in a))
        else:
            out.append(one(a))
    return out


def _diff_inputs(conv):
    res = []
    for a in conv:
        for e in (a if isinstance(a, (list, tuple)) else (a,)):
            if hasattr(e, "stop_gradient") and not e.stop_gradient:
                res.append(e)
    return res


def _outs(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o for o in outs if hasattr(o, "numpy")]


def _np(o):
    v = o.numpy()
    return np.asarray(v)


def _signs(arrs, idx, axis):
    """Fix each column's sign of the factors ``idx`` by the sign of its
    largest entry in the first factor."""
    first = arrs[idx[0]]
    col = np.take_along_axis(first, np.abs(first).argmax(axis=axis)[..., None,
                                                                     :], axis)
    s = np.sign(col)
    s[s == 0] = 1
    for i in idx:
        arrs[i] = arrs[i] * s
    if len(idx) == 1 and len(arrs) > idx[0]:
        pass
    return arrs


def _compare(name, jout, tout, rtol, atol):
    jo, to = _outs(jout), _outs(tout)
    assert len(jo) == len(to), (len(jo), len(to))
    ja, ta = [_np(o) for o in jo], [_np(o) for o in to]
    if name in SIGNED:
        idx, axis = SIGNED[name]
        ja, ta = _signs(ja, idx, axis), _signs(ta, idx, axis)
        if name == "qr":        # R's rows follow Q's columns
            for arrs, src in ((ja, jo), (ta, to)):
                q = _np(src[0])
                col = np.take_along_axis(q, np.abs(q).argmax(0)[None], 0)
                s = np.sign(col).reshape(-1)
                s[s == 0] = 1
                arrs[1] = arrs[1] * s[:, None]
    if name in ("eig", "eigvals"):
        ja = [np.sort_complex(ja[0])]
        ta = [np.sort_complex(ta[0])]
    for k, (a, b) in enumerate(zip(ja, ta)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{k}]")
            assert b.dtype == a.dtype or (a.dtype, b.dtype) == (
                np.int32, np.int64), (a.dtype, b.dtype)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{k}]")


def _scalar(P, outs, weights):
    total = None
    for o, w in zip(outs, weights):
        w = P.to_tensor(w)
        if np.iscomplexobj(_np(o)):
            re, im = (J.real(o), J.imag(o)) if P is J else (o.real, o.imag)
            term = (re * w).sum() + (im * (w * 0.5)).sum()
        else:
            term = (o * w).sum()
        total = term if total is None else total + term
    return total


def _float(o):
    v = _np(o)
    return np.issubdtype(v.dtype, np.floating) or np.iscomplexobj(v)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


@pytest.mark.parametrize("name", _names(HERE))
def test_op_matches_reference(name):
    check_op(name)


def check_op(name):
    """Op ``name``'s values and gradients against the reference's."""
    jfn, tfn = _jfn(name), _tfn(name)
    loose = name in LOOSE
    rtol, atol = (1e-7, 1e-9) if loose else (1e-9, 1e-12)
    for args, kwargs in _cases(name):
        jout = jfn(*_convert(J, args), **kwargs)
        tout = tfn(*_convert(T, args), **kwargs)
        _compare(name, jout, tout, rtol, atol)
        for o in _outs(tout):
            assert type(o) is T.Tensor
        if name in G.WHITELIST or not any(_float(o) for o in _outs(jout)):
            continue
        grtol = G.TOLS.get(name, (1e-7,))[0] if loose else 1e-7
        jin, tin = _convert(J, args, True), _convert(T, args, True)
        jd, td = _diff_inputs(jin), _diff_inputs(tin)
        if not jd:
            continue
        jo = [o for o in _outs(jfn(*jin, **kwargs)) if _float(o)]
        to = [o for o in _outs(tfn(*tin, **kwargs)) if _float(o)]
        weights = [np.random.RandomState(1000 + i).uniform(
            0.5, 1.5, size=_np(o).shape) for i, o in enumerate(jo)]
        if name in SIGNED:       # the cotangent must not see the signs
            continue
        jg = J.grad(_scalar(J, jo, weights), jd, allow_unused=True)
        tg = T.grad(_scalar(T, to, weights), td, allow_unused=True)
        for k, (a, b) in enumerate(zip(jg, tg)):
            if a is None or b is None:
                za = a is None or not np.any(_np(a))
                zb = b is None or not np.any(_np(b))
                assert za and zb, (name, k)
                continue
            np.testing.assert_allclose(_np(b), _np(a), rtol=grtol,
                                       atol=1e-10,
                                       err_msg=f"grad of {name} arg {k}")


def test_every_registered_op_is_tested_or_named():
    """The registry holds the JAX package's 224 op names of these modules;
    each is tested above, or by the random tests, or named in SKIP."""
    from paddle_tpu.ops.registry import OPS as JOPS

    jnames = {n for n, d in JOPS.items() if getattr(
        d.fn, "__module__", "").split(".")[-1] in MODULES + ("random",)}
    assert set(TOPS) == jnames and len(TOPS) == 224
    tested = set(_names()) | RANDOM | set(SKIP)
    assert set(TOPS) <= tested


def test_op_coverage_counts_the_ports_registry():
    cov = T.op_coverage()
    assert cov["registered"] == len(TOPS) == 224
    assert cov["covered"] + len(cov["missing"]) == cov["total"]
    assert 0 < cov["covered"] < cov["total"]
    assert "matmul" not in cov["missing"] and "concat" not in cov["missing"]


def test_create_parameter():
    for P in (J, T):
        p = P.create_parameter([2, 3], dtype="float32")
        assert isinstance(p, P.Parameter) and not p.stop_gradient
        np.testing.assert_array_equal(p.numpy(), np.ones((2, 3)))
        b = P.create_parameter([3], is_bias=True)
        np.testing.assert_array_equal(b.numpy(), np.zeros(3))


def test_is_tensor():
    assert T.is_tensor(T.to_tensor([1.0])) and J.is_tensor(J.to_tensor([1.]))
    assert not T.is_tensor(np.ones(2)) and not J.is_tensor(np.ones(2))


def test_an_op_error_names_the_op_and_its_inputs():
    for P in (J, T):
        with pytest.raises(Exception) as e:
            P.matmul(P.to_tensor(np.ones((2, 3))), P.to_tensor(np.ones((4,
                                                                        5))))
        notes = " ".join(getattr(e.value, "__notes__", []))
        assert "matmul" in notes and "(2, 3)" in notes and "(4, 5)" in notes


# -- random ops: distribution, shape, dtype, determinism -------------------

N = 200000


def _moments(P, fn):
    P.seed(5)
    x = _np(fn(P))
    return x, x.mean(), x.std()


@pytest.mark.parametrize("name,fn,mean,std", [
    ("rand", lambda P: P.rand([N]), 0.5, (1 / 12) ** 0.5),
    ("randn", lambda P: P.randn([N]), 0.0, 1.0),
    ("standard_normal", lambda P: P.standard_normal([N]), 0.0, 1.0),
    ("normal", lambda P: P.normal(1.0, 2.0, [N]), 1.0, 2.0),
    ("uniform", lambda P: P.uniform([N], min=-2.0, max=4.0), 1.0,
     (36 / 12) ** 0.5),
    ("randint", lambda P: P.randint(0, 10, [N]), 4.5, (99 / 12) ** 0.5),
    ("randperm", lambda P: P.randperm(1000), 499.5, (999999 / 12) ** 0.5),
    ("log_normal", lambda P: P.log(P.log_normal(0.5, 0.25, [N])), 0.5, 0.25),
    ("rand_like", lambda P: P.rand_like(P.zeros([N])), 0.5,
     (1 / 12) ** 0.5),
    ("randn_like", lambda P: P.randn_like(P.zeros([N])), 0.0, 1.0),
    ("randint_like", lambda P: P.randint_like(P.zeros([N], "int64"), 0, 4),
     1.5, (15 / 12) ** 0.5),
    ("bernoulli", lambda P: P.bernoulli(P.full([N], 0.3)), 0.3,
     (0.21) ** 0.5),
    ("poisson", lambda P: P.poisson(P.full([N], 3.0)), 3.0, 3.0 ** 0.5),
    ("exponential_", lambda P: P.zeros([N]).exponential_(2.0), 0.5, 0.5),
    ("uniform_", lambda P: P.zeros([N]).uniform_(0.0, 2.0), 1.0,
     (4 / 12) ** 0.5),
    ("normal_", lambda P: P.zeros([N]).normal_(3.0, 0.5), 3.0, 0.5),
])
def test_random_op_moments_as_the_reference(name, fn, mean, std):
    tol = 6 * std / N ** 0.5 if name != "randperm" else 1e-9
    for P in (J, T):
        x, m, s = _moments(P, fn)
        assert abs(m - mean) <= tol + 1e-12, (P.__name__, m, mean)
        assert abs(s - std) <= 0.02 * std, (P.__name__, s, std)
    assert x.shape == _moments(J, fn)[0].shape
    again = _moments(T, fn)[0]
    np.testing.assert_array_equal(again, x)           # paddle.seed repeats
    if name == "randperm":
        assert sorted(x.tolist()) == list(range(1000))


def test_random_dtypes_and_multinomial_and_gumbel():
    for P in (J, T):
        P.seed(3)
        assert str(P.rand([2]).dtype).endswith("float32")
        assert str(P.randint(0, 5, [3]).dtype).endswith("int64")
    rows = T.multinomial(T.to_tensor(np.array([[0.1, 0.0, 0.9],
                                               [0.5, 0.5, 0.0]])), 2000,
                         replacement=True).numpy()
    assert rows.shape == (2, 2000) and not (rows[1] == 2).any()
    for P in (J, T):
        # the JAX package's draw with replacement takes 1-d probabilities
        # only (its categorical's shape); the port's takes rows too
        draw = _np(P.multinomial(P.to_tensor(np.array([0.1, 0.0, 0.9])),
                                 2000, replacement=True))
        assert draw.shape == (2000,) and not (draw == 1).any()
        assert abs((draw == 2).mean() - 0.9) < 0.03
        probs = P.to_tensor(np.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]]))
        nr = _np(P.multinomial(probs, 2))
        assert nr.shape == (2, 2) and sorted(nr[0].tolist()) == [0, 2]
        y = P.gumbel_softmax(P.to_tensor(np.zeros((4, 5))), hard=True)
        np.testing.assert_array_equal(_np(y).sum(-1), np.ones(4))
