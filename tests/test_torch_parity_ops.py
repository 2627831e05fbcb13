"""The rest of the op library (``paddle_tpu_torch.ops.parity``, the
activations and ``rnn`` registered as ops, the aliases over
``nn.functional``, ``fft``'s three ops, and ``ops.detection``'s names
through the registry) against the JAX package's ops of the same names,
one case per op, and the surfaces around them: the coverage count,
``PUBLIC_OPS`` in the namespace and on Tensor, ``paddle.fft``,
``TensorArray`` / ``SelectedRows``, ``FLAGS_check_nan_inf`` /
``FLAGS_benchmark`` and ``text.viterbi_decode``.

Inputs are the seeded cases of ``tools/eager_op_cases.py``
(``REGISTRY_CASES``), handed to both packages as tensors. Values agree
within rtol 1e-9 / atol 1e-12 in f64 (``REGISTRY_LOOSE``: the special
functions and decompositions, 1e-7; ``F32_INSIDE``: the aliases whose
kernels' plain versions compute in f32 whatever the input, 1e-5 / 1e-6,
values and gradients). The reference's flash aliases cannot run on the
CPU (its Pallas path needs x64 off, ROADMAP R1), so ``flash_attn`` and
``flash_attn_unpadded`` are held against the reference's
``scaled_dot_product_attention`` (per packed sequence for the latter).
The reference's ``merged_adam_`` / ``merged_momentum_`` / ``fused_adam_``
wrap each output tuple in one Tensor (R27); their elements are compared
with the port's tuples. Every
op outside ``tests/test_op_grads.WHITELIST`` with a float output has its
gradients of ``sum(out_i * w_i)`` (a complex output contributes ``re *
w + im * w / 2``, real-valued, so JAX's conjugate convention for complex
inputs never enters: every differentiated input is real) held within
rtol 1e-7. The random ops agree in distribution.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests import test_op_grads as G
from tests.test_torch_ops import _convert, _diff_inputs, _np, _scalar
from tools.eager_op_cases import (REGISTRY_LOOSE, REGISTRY_RAISES,
                                  REGISTRY_RANDOM, registry_cases)

torch.set_num_threads(1)
CORE = ("creation", "math", "manipulation", "linalg", "logic", "search",
        "stat", "fused", "random")


def _new_names():
    """The names the reference registers outside its core op modules
    (nine of them, ``max`` ... ``multiplex``, are the port's core math
    functions)."""
    return sorted(n for n, d in JOPS.items()
                  if d.fn.__module__.split(".")[-1] not in CORE)


NAMES = [n for n in _new_names() if n not in REGISTRY_RANDOM
         and n not in REGISTRY_RAISES]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _kw(P, kwargs, grad=False):
    """``kwargs`` with numpy arrays as ``P``'s tensors (float64 ones
    requiring grad when ``grad``)."""
    return {k: _convert(P, [v], grad)[0] if isinstance(v, np.ndarray)
            else v for k, v in kwargs.items()}


# the aliases whose kernels' plain versions compute in f32
F32_INSIDE = {"layer_norm", "cross_entropy_with_softmax",
              "memory_efficient_attention", "flash_attn",
              "flash_attn_unpadded"}


def _flat(out):
    """Tensor leaves of an op's output (tuples of tuples included; the
    reference's Tensors that wrap a tuple, R27, as their elements)."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    if isinstance(getattr(out, "_value", None), tuple):
        return [J.Tensor(v) for v in out._value]
    return [out] if hasattr(out, "numpy") else []


def _sdpa_flash(q, k, v, dropout=0.0, causal=False, **kw):
    return J.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal), None


def _sdpa_varlen(q, k, v, cu_q, cu_k, max_q=None, max_k=None, scale=None,
                 causal=False, **kw):
    cu = [int(c) for c in np.asarray(cu_q.numpy())]
    outs = [J.nn.functional.scaled_dot_product_attention(
        q[None, s:e], k[None, s:e], v[None, s:e], is_causal=causal,
        scale=scale)[0] for s, e in zip(cu[:-1], cu[1:])]
    return J.concat(outs, axis=0), None


# the reference functions the flash aliases are held against (R1)
REFERENCE = {"flash_attn": _sdpa_flash, "flash_attn_unpadded": _sdpa_varlen}


def _float(o):
    v = _np(o)
    return np.issubdtype(v.dtype, np.floating) or np.iscomplexobj(v)


def _compare(name, jout, tout, rtol, atol):
    jo, to = _flat(jout), _flat(tout)
    assert len(jo) == len(to), (name, len(jo), len(to))
    for k, (a, b) in enumerate(zip(jo, to)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{k}]")


def _probe(name):
    def probe(args, kwargs):
        try:
            return bool(_flat(JOPS[name].fn(*_convert(J, args),
                                            **_kw(J, kwargs))))
        except Exception:
            return False

    return probe


@pytest.mark.parametrize("name", NAMES)
def test_registry_op_matches_reference(name):
    jfn, tfn = REFERENCE.get(name, JOPS[name].fn), TOPS[name].fn
    loose = name in REGISTRY_LOOSE
    rtol, atol = (1e-5, 1e-6) if name in F32_INSIDE else (
        1e-7, 1e-9) if loose else (1e-9, 1e-12)
    for args, kwargs in registry_cases(name, _probe(name)):
        jout = jfn(*_convert(J, args), **_kw(J, kwargs))
        tout = tfn(*_convert(T, args), **_kw(T, kwargs))
        _compare(name, jout, tout, rtol, atol)
        for o in _flat(tout):
            assert isinstance(o, T.Tensor), (name, type(o))
        if name in G.WHITELIST or not any(_float(o) for o in _flat(jout)):
            continue
        jin, tin = _convert(J, args, True), _convert(T, args, True)
        jkw, tkw = _kw(J, kwargs, True), _kw(T, kwargs, True)
        jd = _diff_inputs(jin + list(jkw.values()))
        td = _diff_inputs(tin + list(tkw.values()))
        if not jd:
            continue
        jo = [o for o in _flat(jfn(*jin, **jkw)) if _float(o)]
        to = [o for o in _flat(tfn(*tin, **tkw)) if _float(o)]
        weights = [np.random.RandomState(1000 + i).uniform(
            0.5, 1.5, size=_np(o).shape) for i, o in enumerate(jo)]
        jg = J.grad(_scalar(J, jo, weights), jd, allow_unused=True)
        tg = T.grad(_scalar(T, to, weights), td, allow_unused=True)
        grtol = 1e-5 if name in F32_INSIDE else G.TOLS.get(
            name, (1e-7,))[0] if loose else 1e-7
        for k, (a, b) in enumerate(zip(jg, tg)):
            if a is None or b is None:
                assert (a is None or not np.any(_np(a))) and (
                    b is None or not np.any(_np(b))), (name, k)
                continue
            np.testing.assert_allclose(_np(b), _np(a), rtol=grtol,
                                       atol=1e-7 if name in F32_INSIDE
                                       else 1e-10,
                                       err_msg=f"grad of {name} arg {k}")


def test_the_registry_holds_the_references_names():
    """The registry holds the JAX package's 408 op names; every one of
    this file's is tested above, drawn at random below or raises."""
    assert set(TOPS) == set(JOPS) and len(TOPS) == 408
    assert set(_new_names()) == set(NAMES) | REGISTRY_RANDOM | set(
        REGISTRY_RAISES)
    assert len(_new_names()) == 184


def test_class_center_sample_raises_in_both():
    for ops in (JOPS, TOPS):
        with pytest.raises(NotImplementedError):
            ops["class_center_sample"].fn(T.to_tensor(np.arange(4)), 10, 2)


def test_aliases_are_the_ports_functionals():
    F = T.nn.functional
    for name, fn in [("flash_attn", F.flash_attention),
                     ("flash_attn_unpadded", F.flash_attn_unpadded),
                     ("layer_norm", F.layer_norm),
                     ("cross_entropy_with_softmax",
                      F.softmax_with_cross_entropy),
                     ("warpctc", F.ctc_loss), ("warprnnt", F.rnnt_loss),
                     ("conv2d", F.conv2d), ("relu", F.relu),
                     ("tanh_act", F.tanh), ("logsigmoid", F.log_sigmoid)]:
        assert TOPS[name].fn is fn, name


# -- random ops: distribution, shape, dtype, determinism -------------------

N = 200000


@pytest.mark.parametrize("name,fn,mean,std", [
    ("gaussian", lambda P: P.ops.registry.OPS["gaussian"].fn(
        [N], mean=1.0, std=2.0), 1.0, 2.0),
    ("truncated_gaussian_random", lambda P: P.ops.registry.OPS[
        "truncated_gaussian_random"].fn([N], mean=0.5, std=1.5), 0.5,
     1.5 * 0.8796256610342398),
    ("uniform_inplace", lambda P: P.ops.registry.OPS["uniform_inplace"].fn(
        P.zeros([N]), min=-1.0, max=3.0), 1.0, (16 / 12) ** 0.5),
    ("dirichlet", lambda P: P.ops.registry.OPS["dirichlet"].fn(
        P.to_tensor(np.tile([[0.5, 2.0, 3.5]], (N // 4, 1))))[:, 1],
     2.0 / 6.0, (2.0 * 4.0 / (36.0 * 7.0)) ** 0.5),
])
def test_random_registry_ops_in_distribution(name, fn, mean, std):
    tol = 6 * std / (N // 4) ** 0.5
    for P in (J, T):
        P.seed(5)
        x = _np(fn(P))
        assert np.isfinite(x).all()
        assert abs(x.mean() - mean) <= tol, (P.__name__, x.mean(), mean)
        assert abs(x.std() - std) <= 0.03 * std, (P.__name__, x.std(), std)
    T.seed(5)
    np.testing.assert_array_equal(_np(fn(T)), x)        # paddle.seed repeats
    if name == "truncated_gaussian_random":
        assert np.abs(x - 0.5).max() <= 2 * 1.5 + 1e-6
    if name == "dirichlet":
        T.seed(1)
        rows = _np(TOPS["dirichlet"].fn(T.to_tensor(np.full((64, 3), 0.3))))
        np.testing.assert_allclose(rows.sum(-1), 1.0, rtol=1e-12)
        assert (rows >= 0).all()


# -- the namespace and Tensor methods --------------------------------------

def test_public_ops_in_the_namespace_and_on_tensor():
    from paddle_tpu_torch.ops.parity import PUBLIC_OPS

    x = np.random.RandomState(0).uniform(0.5, 1.5, (3, 3))
    for name in ("inverse", "complex", "bincount", "i0e", "reverse",
                 "diag_embed", "tril_indices"):
        assert getattr(T, name) is PUBLIC_OPS[name]
    t = T.to_tensor(x)
    np.testing.assert_allclose(T.inverse(t).numpy(), np.linalg.inv(x),
                               rtol=1e-10)
    np.testing.assert_allclose(t.i0e().numpy(), J.to_tensor(x).numpy() * 0
                               + _np(JOPS["i0e"].fn(J.to_tensor(x))),
                               rtol=1e-7)
    assert type(t.reverse([0])) is T.Tensor
    # max / min / all / any / sum keep the core ops' and the builtins'
    assert T.max is T.ops.math.max and max(3, 4) == 4
    assert all([True]) and not any([False]) and sum([1, 2]) == 3
    import paddle_tpu_torch.ops.parity as parity_mod

    assert "max" not in vars(parity_mod) and "all" not in vars(parity_mod)


def test_coverage_names_the_sparse_and_collective_rest():
    cov = T.op_coverage()
    missing = cov["missing"]
    assert cov["covered"] == 412 and cov["total"] == 460
    assert len([m for m in missing if m.startswith("sparse.")]) == 48
    # the static collectives count against distributed.collective's verbs
    assert [m for m in missing if not m.startswith("sparse.")] == []
