"""The vision slice's ``nn`` surface in the PyTorch port (paddle_tpu_torch)
against the JAX package, on the CPU: pooling, activations, batch norm,
``Linear`` / ``Flatten`` / ``Sequential``, ``CrossEntropyLoss``,
``ConvNormActivation``, SGD / Momentum and ``PiecewiseDecay``.

Every comparison feeds both packages the same seeded numpy inputs (and
weights, where a layer has them), in f32. Tolerances: outputs atol 1e-5,
rtol 1e-5 (XLA and torch sum a window or a batch in different orders);
gradients atol = rtol = 1e-5; parameters and velocities after optimizer
steps atol = rtol = 1e-5 (the same elementwise update, on gradients that
differ in summation order); integer indices exactly. Inputs are
continuous random values, so no two elements of a pooling window tie and
no activation input sits on a kink.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.optimizer.lr import PiecewiseDecay as JPiecewiseDecay
from paddle_tpu.vision.ops import ConvNormActivation as JConvNormActivation

from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, Momentum, PiecewiseDecay
from paddle_tpu_torch.vision.ops import ConvNormActivation

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-5)


def _j(a, grad=False):
    return paddle_tpu.to_tensor(np.ascontiguousarray(a),
                                stop_gradient=not grad)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "_value") else \
        t.detach().numpy()


def _both(jfn, tfn, x, grad=True, seed=0):
    """Outputs of ``jfn`` / ``tfn`` on ``x`` and, with ``grad``, the input
    gradients of ``sum(out * w)`` for a seeded ``w``."""
    jx, tx = _j(x, grad), _t(x, grad)
    jy, ty = jfn(jx), tfn(tx)
    jout = jy[0] if isinstance(jy, (tuple, list)) else jy
    tout = ty[0] if isinstance(ty, (tuple, list)) else ty
    res = {"out": (_np(jout), _np(tout))}
    if isinstance(jy, (tuple, list)):
        res["mask"] = (_np(jy[1]), _np(ty[1]))
    if grad:
        w = np.random.RandomState(seed + 1).randn(*tout.shape).astype(
            np.float32)
        (jout * _j(w)).sum().backward()
        (tout * _t(w)).sum().backward()
        res["grad"] = (_np(jx.grad), _np(tx.grad))
    return res


def _assert_same(res):
    for key, (want, got) in res.items():
        assert got.shape == want.shape, key
        if key == "mask":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, err_msg=key,
                                       **(GRAD if key == "grad" else ACT))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# pooling functionals
# ---------------------------------------------------------------------------

# (name, input shape, keyword arguments); every window holds a real
# element, so the gradient cases are finite
POOL_CASES = [
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True)),
    ("max_pool2d", (2, 3, 7, 7), dict(kernel_size=2, stride=2,
                                      ceil_mode=True)),
    ("max_pool2d", (2, 3, 7, 8), dict(kernel_size=(3, 2), stride=(2, 3),
                                      padding=(1, 0))),
    ("max_pool2d", (2, 3, 7, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 3, 7, 8), dict(kernel_size=3, stride=2,
                                      padding="valid")),
    ("max_pool2d", (2, 7, 8, 3), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True, data_format="NHWC")),
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                    ceil_mode=True)),
    ("max_pool1d", (2, 3, 11), dict(kernel_size=4, padding="SAME")),
    ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                         padding=1, ceil_mode=True)),
    ("avg_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True)),
    ("avg_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True, exclusive=False)),
    ("avg_pool2d", (2, 3, 7, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("avg_pool2d", (2, 3, 7, 8), dict(kernel_size=(2, 3), padding="VALID",
                                      ceil_mode=True)),
    ("avg_pool2d", (2, 7, 8, 3), dict(kernel_size=3, stride=2, padding=1,
                                      data_format="NHWC")),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                    ceil_mode=True)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                    exclusive=False)),
    ("avg_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2,
                                         padding=1, ceil_mode=True)),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), dict(output_size=2)),
    ("adaptive_avg_pool2d", (2, 3, 7, 5), dict(output_size=(3, 4))),
    ("adaptive_avg_pool2d", (2, 3, 1, 1), dict(output_size=(6, 6))),
    ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=4)),
    ("adaptive_avg_pool3d", (1, 2, 4, 5, 6), dict(output_size=(2, 3, 4))),
    ("adaptive_max_pool2d", (2, 3, 7, 5), dict(output_size=(3, 2))),
    ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=3)),
    ("adaptive_max_pool3d", (1, 2, 4, 5, 6), dict(output_size=2)),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling_matches_reference(case):
    name, shape, kw = POOL_CASES[case]
    res = _both(lambda x: getattr(JF, name)(x, **kw),
                lambda x: getattr(TF, name)(x, **kw), _x(shape, case))
    _assert_same(res)


MASK_CASES = [
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 8, 7), dict(kernel_size=3, stride=2, padding=1,
                                      ceil_mode=True)),
    ("max_pool2d", (2, 3, 7, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 7, 8, 3), dict(kernel_size=2, stride=2,
                                      ceil_mode=True, data_format="NHWC")),
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                         padding=1, ceil_mode=True)),
]


@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_max_pool_return_mask_matches_reference(case):
    """Values, gradients and the argmax indices into the unpadded plane."""
    name, shape, kw = MASK_CASES[case]
    res = _both(lambda x: getattr(JF, name)(x, return_mask=True, **kw),
                lambda x: getattr(TF, name)(x, return_mask=True, **kw),
                _x(shape, 40 + case))
    assert res["mask"][1].dtype == np.int64
    _assert_same(res)


@pytest.mark.parametrize("exclusive", [True, False])
def test_ceil_mode_window_in_the_padding_is_kept(exclusive):
    """A ceil-mode window that lies wholly in the padding (L 5, kernel 2,
    stride 2, padding 1: windows over padded 0-1, 2-3, 4-5, 6-7, the last
    all padding) is kept, as the reference keeps it: max -inf, average 0
    (``exclusive=False``) or 0 / 0 (``exclusive=True``); torch's own
    ``ceil_mode`` would drop it."""
    x = _x((1, 2, 5), 7)
    mx = _both(lambda v: JF.max_pool1d(v, 2, 2, 1, ceil_mode=True),
               lambda v: TF.max_pool1d(v, 2, 2, 1, ceil_mode=True), x,
               grad=False)
    av = _both(lambda v: JF.avg_pool1d(v, 2, 2, 1, exclusive, True),
               lambda v: TF.avg_pool1d(v, 2, 2, 1, exclusive, True), x,
               grad=False)
    _assert_same(mx)
    _assert_same(av)
    assert mx["out"][1].shape == (1, 2, 4)
    assert np.isneginf(mx["out"][1][..., -1]).all()
    last = av["out"][1][..., -1]
    assert (np.isnan(last) if exclusive else last == 0).all()
    assert torch.nn.functional.max_pool1d(_t(x), 2, 2, 1,
                                          ceil_mode=True).shape[-1] == 3


def test_adaptive_pooling_ignores_data_format_as_the_reference():
    """R7: the reference's adaptive pools bin the dims after the first two
    whatever ``data_format`` says; the port does the same."""
    x = _x((2, 6, 4, 3), 9)
    res = _both(lambda v: JF.adaptive_avg_pool2d(v, 2, data_format="NHWC"),
                lambda v: TF.adaptive_avg_pool2d(v, 2, data_format="NHWC"),
                x)
    _assert_same(res)
    assert res["out"][1].shape == (2, 6, 2, 2)


def test_adaptive_max_return_mask_raises_as_the_reference():
    for fn in (JF.adaptive_max_pool2d, TF.adaptive_max_pool2d):
        x = _j(_x((1, 1, 4, 4))) if fn is JF.adaptive_max_pool2d else \
            _t(_x((1, 1, 4, 4)))
        with pytest.raises(NotImplementedError):
            fn(x, 2, return_mask=True)


# ---------------------------------------------------------------------------
# pooling layers
# ---------------------------------------------------------------------------

LAYER_CASES = [
    ("MaxPool1D", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("MaxPool2D", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                     ceil_mode=True)),
    ("MaxPool3D", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2)),
    ("AvgPool1D", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                   exclusive=False)),
    ("AvgPool2D", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                     ceil_mode=True)),
    ("AvgPool3D", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                        padding=1)),
    ("AdaptiveAvgPool1D", (2, 3, 10), dict(output_size=3)),
    ("AdaptiveAvgPool2D", (2, 3, 7, 7), dict(output_size=(1, 1))),
    ("AdaptiveAvgPool3D", (1, 2, 4, 5, 6), dict(output_size=2)),
    ("AdaptiveMaxPool1D", (2, 3, 10), dict(output_size=4)),
    ("AdaptiveMaxPool2D", (2, 3, 7, 5), dict(output_size=(2, 3))),
    ("AdaptiveMaxPool3D", (1, 2, 4, 5, 6), dict(output_size=(1, 2, 3))),
]


@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_pooling_layers_match_reference(case):
    name, shape, kw = LAYER_CASES[case]
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    _assert_same(_both(jl, tl, _x(shape, 60 + case)))


def test_max_pool_layer_return_mask():
    x = _x((2, 3, 9, 8), 3)
    res = _both(jnn.MaxPool2D(3, 2, 1, return_mask=True),
                tnn.MaxPool2D(3, 2, 1, return_mask=True), x)
    _assert_same(res)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("elu", dict(alpha=0.7)), ("selu", {}),
    ("celu", dict(alpha=1.3)), ("gelu", {}), ("gelu", dict(approximate=True)),
    ("sigmoid", {}), ("log_sigmoid", {}), ("tanh", {}), ("softmax", {}),
    ("softmax", dict(axis=1)), ("log_softmax", dict(axis=0)),
    ("leaky_relu", dict(negative_slope=0.2)), ("rrelu", {}), ("silu", {}),
    ("swish", {}), ("mish", {}), ("hardswish", {}), ("hardsigmoid", {}),
    ("hardsigmoid", dict(slope=0.2, offset=0.4)),
    ("hardtanh", dict(min=-0.5, max=2.0)), ("hardshrink", {}),
    ("softshrink", dict(threshold=0.3)), ("tanhshrink", {}),
    ("thresholded_relu", dict(threshold=0.4)), ("softplus", {}),
    ("softplus", dict(beta=2.0, threshold=3.0)), ("softsign", {}),
    ("maxout", dict(groups=2)), ("glu", {}),
]


@pytest.mark.parametrize("case", range(len(ACTIVATIONS)))
def test_activation_matches_reference(case):
    name, kw = ACTIVATIONS[case]
    x = 4 * _x((3, 4, 6), 80 + case)    # spans relu6's and hardswish's kinks
    _assert_same(_both(lambda v: getattr(JF, name)(v, **kw),
                       lambda v: getattr(TF, name)(v, **kw), x))


@pytest.mark.parametrize("n_weights,fmt", [(1, "NCHW"), (4, "NCHW"),
                                            (3, "NHWC")])
def test_prelu_matches_reference(n_weights, fmt):
    x = _x((2, 4, 5, 3), 5)
    w = np.random.RandomState(6).rand(n_weights).astype(np.float32)
    jl = jnn.PReLU(n_weights, data_format=fmt)
    tl = tnn.PReLU(n_weights, data_format=fmt, device="cpu")
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  _np(jl.weight))      # init 0.25
    jl.weight._value = _j(w)._value
    with torch.no_grad():
        tl.weight.copy_(_t(w))
    _assert_same(_both(jl, tl, x))
    np.testing.assert_allclose(tl.weight.grad.numpy(), _np(jl.weight.grad),
                               **GRAD)


def test_activation_layers_match_reference():
    x = 3 * _x((2, 6, 4), 8)
    names = [n for n in jnn.layers.activation.__all__
             if n not in ("PReLU", "Maxout")]
    assert set(names) <= set(tnn.__all__)
    for name in names:
        _assert_same(_both(getattr(jnn, name)(), getattr(tnn, name)(), x,
                           seed=len(name)))
    _assert_same(_both(jnn.Maxout(3), tnn.Maxout(3), x))
    _assert_same(_both(jnn.LeakyReLU(negative_slope=0.3),
                       tnn.LeakyReLU(negative_slope=0.3), x))
    # RReLU takes the mean slope in training too, as the reference does
    jr, tr = jnn.RReLU(0.1, 0.3), tnn.RReLU(0.1, 0.3)
    jr.train()
    tr.train()
    _assert_same(_both(jr, tr, x))


def test_one_hot_and_gumbel_softmax():
    lab = np.array([0, 3, 2, 1])
    np.testing.assert_array_equal(
        TF.one_hot(_t(lab), 5).numpy(),
        np.asarray(JF.one_hot(_j(lab), 5).numpy()))
    x = _t(_x((4000, 3), 1))
    x = torch.zeros_like(x) + torch.tensor([0.0, 1.0, 2.0])
    soft = TF.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    hard = TF.gumbel_softmax(x, hard=True)
    np.testing.assert_allclose(hard.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(hard.amax(-1).numpy(), 1.0, rtol=1e-6)
    # the argmax of x + Gumbel noise is a draw from softmax(x)
    freq = hard.mean(0).numpy()
    np.testing.assert_allclose(freq, torch.softmax(x[0], 0).numpy(),
                               atol=0.03)


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

BN_CASES = [("BatchNorm2D", (4, 3, 5, 6), "NCHW"),
            ("BatchNorm2D", (4, 5, 6, 3), "NHWC"),
            ("BatchNorm1D", (6, 3, 7), "NCL"),
            ("BatchNorm1D", (8, 3), "NCL"),
            ("BatchNorm3D", (2, 3, 3, 4, 5), "NCDHW"),
            ("BatchNorm", (4, 3, 5, 6), "NCHW")]


def _bn_pair(name, C, data_format, seed):
    rng = np.random.RandomState(seed)
    jl = getattr(jnn, name)(C, momentum=0.8, data_format=data_format)
    tl = getattr(tnn, name)(C, momentum=0.8, data_format=data_format,
                            device="cpu")
    state = {"weight": 1 + rng.rand(C), "bias": rng.randn(C),
             "_mean": rng.randn(C), "_variance": 1 + rng.rand(C)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    for n, v in state.items():
        getattr(jl, n)._value = _j(v)._value
    tl.load_state_dict(vision_state_from_jax(state, tl))
    return jl, tl


@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batch_norm_train_and_eval_match_reference(case):
    """Training: output, every gradient and the running buffers after the
    step (Paddle's momentum on the OLD value, the biased variance); then
    eval on the running statistics."""
    name, shape, fmt = BN_CASES[case]
    C = shape[1] if fmt.startswith("NC") else shape[-1]
    jl, tl = _bn_pair(name, C, fmt, case)
    x = 3 * _x(shape, 100 + case) + 1.5
    _assert_same(_both(jl, tl, x))
    for n in ("weight", "bias"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   _np(getattr(jl, n).grad), err_msg=n,
                                   **GRAD)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(tl.get_buffer(n).numpy(),
                                   _np(getattr(jl, n)), err_msg=n, **ACT)
    jl.eval()
    tl.eval()
    _assert_same(_both(jl, tl, _x(shape, 200 + case)))


def test_batch_norm_functional_matches_reference():
    x = _x((4, 3, 5, 5), 3)
    rm, rv = _x((3,), 4), 1 + np.abs(_x((3,), 5))
    w, b = _x((3,), 6), _x((3,), 7)
    for training in (True, False):
        res = _both(
            lambda v: JF.batch_norm(v, _j(rm), _j(rv), _j(w), _j(b),
                                    training=training),
            lambda v: TF.batch_norm(v, _t(rm), _t(rv), _t(w), _t(b),
                                    training=training), x)
        _assert_same(res)


def test_batch_norm_single_value_per_channel():
    """One value a channel in training: the biased variance is 0 and the
    buffers blend it in (torch's fused op alone would write an infinite
    unbiased variance). The output is the bias; each side's rounding of
    ``x - mean`` is multiplied by ``1 / sqrt(eps)`` (316), hence atol
    1e-4 on it."""
    jl, tl = _bn_pair("BatchNorm1D", 3, "NCL", 1)
    res = _both(jl, tl, _x((1, 3), 2))
    np.testing.assert_allclose(*res.pop("out"), atol=1e-4, rtol=0)
    _assert_same(res)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(tl.get_buffer(n).numpy(),
                                   _np(getattr(jl, n)), err_msg=n, **ACT)


def test_batch_norm_under_o1_takes_f32_statistics():
    """R8: under O1 the port casts a bf16 input to f32 before batch norm
    and takes the batch statistics in f32: output and buffers are exactly
    f32 batch norm of the upcast input. The reference takes the statistics
    from the bf16 input (``batch_norm_stats`` is not on amp's black list),
    so its running mean is the blend of the bf16-rounded batch mean."""
    import paddle_tpu.amp as jamp

    x = 3 * _x((4, 3, 5, 6), 3) + 1.5
    xb = torch.from_numpy(x).bfloat16()
    jl, tl = _bn_pair("BatchNorm2D", 3, "NCHW", 4)
    _, f32 = _bn_pair("BatchNorm2D", 3, "NCHW", 4)
    with amp.auto_cast(level="O1"):
        out = tl(xb)
    want = f32(xb.float())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(tl._mean, f32._mean, rtol=0, atol=0)
    torch.testing.assert_close(tl._variance, f32._variance, rtol=0, atol=0)
    with jamp.auto_cast(level="O1"):
        jl(_j(xb.float().numpy()).astype("bfloat16"))
    # the reference's buffers carry bf16 rounding (8 significant bits)
    ref, port = _np(jl._mean), tl._mean.numpy()
    np.testing.assert_allclose(ref, port, rtol=2 ** -6, atol=0)
    assert not np.allclose(ref, port, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Linear, Flatten, Identity, Sequential, CrossEntropyLoss, ConvNormActivation
# ---------------------------------------------------------------------------

def test_linear_matches_reference_and_keeps_paddle_init():
    paddle_tpu.seed(3)
    jl = jnn.Linear(6, 4)
    tl = tnn.Linear(6, 4, device="cpu")
    arrays = {n: _np(p) for n, p in jl.named_parameters()}
    # Paddle's [in, out] in both (ROADMAP F4)
    assert tl.weight.shape == (6, 4) and arrays["weight"].shape == (6, 4)
    tl.load_state_dict(vision_state_from_jax(arrays, tl))
    _assert_same(_both(jl, tl, _x((3, 5, 6), 1)))
    np.testing.assert_allclose(tl.weight.grad.numpy(), _np(jl.weight.grad),
                               **GRAD)
    fresh = tnn.Linear(300, 200, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    bound = (6 / 500) ** 0.5                       # Xavier-uniform
    w = fresh.weight.detach()
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    assert torch.equal(fresh.bias, torch.zeros(200))
    assert tnn.Linear(3, 2, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("start,stop", [(1, -1), (0, 1), (1, 2), (-2, -1)])
def test_flatten_matches_reference(start, stop):
    x = _x((2, 3, 4, 5), 2)
    _assert_same(_both(jnn.Flatten(start, stop), tnn.Flatten(start, stop),
                       x))


def test_identity_and_sequential():
    x = _x((2, 4), 5)
    assert torch.equal(tnn.Identity(3, k=1)(_t(x)), _t(x))
    paddle_tpu.seed(1)
    jseq = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU(), jnn.Linear(3, 2))
    tseq = tnn.Sequential(tnn.Linear(4, 3, device="cpu"), tnn.ReLU(),
                          tnn.Linear(3, 2, device="cpu"))
    arrays = {n: _np(p) for n, p in jseq.named_parameters()}
    assert set(arrays) == set(tseq.state_dict())
    tseq.load_state_dict(vision_state_from_jax(arrays, tseq))
    _assert_same(_both(jseq, tseq, x))
    assert len(tseq) == 3 and isinstance(tseq[1], tnn.ReLU)
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.Flatten()))
    listed = tnn.Sequential([("a", tnn.ReLU()), ("b", tnn.Flatten())])
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    assert [n for n, _ in listed.named_children()] == ["a", "b"]
    jnamed = jnn.Sequential(("a", jnn.ReLU()), ("b", jnn.Flatten()))
    assert list(jnamed._sub_layers) == ["a", "b"]


@pytest.mark.parametrize("label_shape", ["[N]", "[N, 1]"])
def test_cross_entropy_loss_layer_matches_reference(label_shape):
    x = 2 * _x((6, 10), 4)
    lab = np.random.RandomState(5).randint(0, 10, 6).astype(np.int64)
    if label_shape == "[N, 1]":
        lab = lab[:, None]
    jx, tx = _j(x, True), _t(x, True)
    jloss = jnn.CrossEntropyLoss()(jx, _j(lab))
    tloss = tnn.CrossEntropyLoss()(tx, _t(lab))
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), **ACT)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **GRAD)


@pytest.mark.parametrize("groups,act", [(1, "ReLU"), (4, "Hardswish"),
                                        (1, None)])
def test_conv_norm_activation_matches_reference(groups, act):
    paddle_tpu.seed(2)
    jb = JConvNormActivation(4, 8, 3, stride=2, groups=groups,
                             activation_layer=act and getattr(jnn, act))
    tb = ConvNormActivation(4, 8, 3, stride=2, groups=groups,
                            activation_layer=act and getattr(tnn, act),
                            device="cpu")
    arrays = {n: _np(p) for n, p in jb.named_parameters()}
    arrays.update({n: _np(b) for n, b in jb.named_buffers()})
    assert set(arrays) == set(tb.state_dict())
    assert "0.bias" not in arrays                 # no bias before a norm
    tb.load_state_dict(vision_state_from_jax(arrays, tb))
    _assert_same(_both(jb, tb, _x((2, 4, 9, 9), 3)))
    np.testing.assert_allclose(tb[0].weight.grad.numpy(),
                               _np(jb[0].weight.grad), **GRAD)
    for n, b in jb.named_buffers():
        np.testing.assert_allclose(tb.get_buffer(n).numpy(), _np(b),
                                   err_msg=n, **ACT)


def test_vision_state_from_jax_raises_on_unknown_name():
    tb = ConvNormActivation(2, 4, 3, device="cpu")
    good = {n: t.numpy() for n, t in tb.state_dict().items()}
    assert set(vision_state_from_jax(good, tb)) == set(good)
    with pytest.raises(KeyError, match="nope"):
        vision_state_from_jax({**good, "1.nope": good["1.weight"]}, tb)
    with pytest.raises(KeyError):
        vision_state_from_jax({"5.weight": good["1.weight"]}, tb)


# ---------------------------------------------------------------------------
# optimizers and the schedule
# ---------------------------------------------------------------------------

def _opt_models(seed):
    paddle_tpu.seed(seed)
    jm = jnn.Linear(5, 3)
    tm = tnn.Linear(5, 3, device="cpu")
    arrays = {n: _np(p) for n, p in jm.named_parameters()}
    tm.load_state_dict(vision_state_from_jax(arrays, tm))
    return jm, tm


OPTIMIZERS = {
    "sgd": (lambda j, lr: JSGD(learning_rate=lr, parameters=j),
            lambda t, lr: SGD(learning_rate=lr, parameters=t)),
    "sgd_l2": (lambda j, lr: JSGD(learning_rate=lr, parameters=j,
                                  weight_decay=0.1),
               lambda t, lr: SGD(learning_rate=lr, parameters=t,
                                 weight_decay=0.1)),
    "momentum": (lambda j, lr: JMomentum(learning_rate=lr, momentum=0.9,
                                         parameters=j),
                 lambda t, lr: Momentum(learning_rate=lr, momentum=0.9,
                                        parameters=t)),
    "momentum_l2": (lambda j, lr: JMomentum(learning_rate=lr, momentum=0.8,
                                            parameters=j, weight_decay=1e-2),
                    lambda t, lr: Momentum(learning_rate=lr, momentum=0.8,
                                           parameters=t, weight_decay=1e-2)),
    "nesterov_l2": (lambda j, lr: JMomentum(learning_rate=lr, momentum=0.9,
                                            parameters=j, use_nesterov=True,
                                            weight_decay=1e-2),
                    lambda t, lr: Momentum(learning_rate=lr, momentum=0.9,
                                           parameters=t, use_nesterov=True,
                                           weight_decay=1e-2)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_three_steps_match_reference(name):
    """Three steps on the same gradients: the parameters (and Momentum's
    velocities) after each."""
    jm, tm = _opt_models(7)
    jopt = OPTIMIZERS[name][0](jm.parameters(), 0.05)
    topt = OPTIMIZERS[name][1](tm.parameters(), 0.05)
    x, y = _x((4, 5), 1), _x((4, 3), 2)
    for step in range(3):
        jl = ((jm(_j(x)) - _j(y)) ** 2).sum()
        tl = ((tm(_t(x)) - _t(y)) ** 2).sum()
        jl.backward()
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        np.testing.assert_allclose(tm.weight.detach().numpy(),
                                   _np(jm.weight), err_msg=f"step {step}",
                                   **GRAD)
        np.testing.assert_allclose(tm.bias.detach().numpy(), _np(jm.bias),
                                   **GRAD)
    if name.startswith(("momentum", "nesterov")):
        jv = jopt._accumulators[id(jm.weight)]["velocity"]
        tv = topt.state_for(tm.weight)["velocity"]
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **GRAD)


def test_piecewise_decay_sequence_matches_reference():
    args = ([3, 6, 9], [0.1, 0.01, 0.001, 0.0001])
    js, ts = JPiecewiseDecay(*args), PiecewiseDecay(*args)
    seq = []
    for _ in range(12):
        seq.append((ts(), ts.get_lr(), js()))
        js.step()
        ts.step()
    assert [a for a, _, _ in seq] == [c for _, _, c in seq]
    assert [a for a, _, _ in seq] == [0.1] * 3 + [0.01] * 3 + \
        [0.001] * 3 + [0.0001] * 3
    late = PiecewiseDecay(*args, last_epoch=20)
    assert late() == 0.0001


def test_momentum_reads_piecewise_decay_each_step():
    """The optimizer reads the schedule at each step; the caller steps the
    schedule, as in Paddle."""
    w = torch.nn.Parameter(torch.ones(2))
    sched = PiecewiseDecay([1], [0.5, 0.1])
    opt = Momentum(learning_rate=sched, momentum=0.0, parameters=[w])
    for _ in range(2):
        w.grad = torch.ones(2)
        opt.step()
        sched.step()
    np.testing.assert_allclose(w.detach().numpy(), 1 - 0.5 - 0.1)
