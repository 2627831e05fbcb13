"""The rest of the ``nn`` surface in the PyTorch port (paddle_tpu_torch):
the functionals and layers the vision and sequence slices had left out,
against the JAX package on the CPU in f32.

Every case feeds both packages the same seeded numpy inputs (and the
reference's weights, where a layer has them) and compares the outputs
and the gradients of ``sum(out * w)`` for a seeded cotangent ``w`` with
respect to every float input the reference differentiates. Tolerances:
atol = rtol = 1e-5 (the same formulas summed in another order), 1e-4 for
the convolutions and the resizes (longer sums; XLA's convolutions and
torch's order them differently). Random masks (the dropouts) agree in
distribution only, as ``dropout``'s do (ROADMAP's sampling contract).

Also the reference's faults the port keeps (ROADMAP Queue 3): R16, the
transposed convolutions do not flip the kernel and ignore
``output_size``; R17, ``interpolate`` is ``jax.image.resize`` (half-pixel
centres, antialiased downsampling, ``align_corners`` ignored), not
Paddle's or torch's.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
CONV = dict(atol=1e-4, rtol=1e-4)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _weights(outs, seed):
    """A seeded cotangent for each output."""
    return [np.asarray(_f(_rs(seed + 100 + k), *o.shape) if o.ndim
                       else 1.5, np.float32) for k, o in enumerate(outs)]


def _run_ref(fn, arrays, diff, kwargs, seed):
    ts = [paddle_tpu.to_tensor(a, stop_gradient=i not in diff)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    kwargs = {k: paddle_tpu.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
    out = fn(*ts, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    vals = [np.asarray(o.numpy()) for o in outs]
    grads = []
    if diff:
        total = sum((o * paddle_tpu.to_tensor(w)).sum()
                    for o, w in zip(outs, _weights(vals, seed)))
        total.backward()
        grads = [np.asarray(ts[i].grad.numpy()) for i in diff]
    return vals, grads


def _run_port(fn, arrays, diff, kwargs, seed):
    ts = [torch.tensor(a, requires_grad=i in diff)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    kwargs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
    out = fn(*ts, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    vals = [o.detach().numpy() for o in outs]
    grads = []
    if diff:
        total = sum((o * torch.from_numpy(w)).sum()
                    for o, w in zip(outs, _weights(vals, seed)))
        total.backward()
        # an input that reaches the output only through a comparison (a
        # label of +-1) gets no gradient here and a zero one there
        grads = [np.zeros(arrays[i].shape, np.float32) if ts[i].grad is None
                 else ts[i].grad.numpy() for i in diff]
    return vals, grads


def _check(name, arrays, kwargs=None, diff=None, tol=TOL, seed=0):
    """``F.<name>`` of both packages on ``arrays``: outputs and the
    gradients of every float input (``diff``: their indices)."""
    kwargs = kwargs or {}
    if diff is None:
        diff = [i for i, a in enumerate(arrays)
                if isinstance(a, np.ndarray) and a.dtype == np.float32]
    jv, jg = _run_ref(getattr(JF, name), arrays, diff, kwargs, seed)
    tv, tg = _run_port(getattr(TF, name), arrays, diff, kwargs, seed)
    assert len(jv) == len(tv)
    for k, (a, b) in enumerate(zip(jv, tv)):
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, err_msg=f"{name} out {k}", **tol)
    for i, a, b in zip(diff, jg, tg):
        np.testing.assert_allclose(b, a, err_msg=f"{name} grad {i}", **tol)


def test_every_public_name_of_the_reference_is_ported():
    """0 of the reference's 96 ``nn.functional`` callables and 0 of its
    116 ``nn`` classes missing, and nothing the reference lacks."""
    def callables(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and callable(getattr(mod, n))
                and not inspect.ismodule(getattr(mod, n))}

    def classes(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and inspect.isclass(getattr(mod, n))}

    assert callables(TF) == callables(JF)
    assert len(callables(JF)) == 96
    assert classes(tnn) == classes(jnn)
    assert len(classes(jnn)) == 116


rs = _rs(0)
COMMON = {
    "linear": ([_f(rs, 3, 4), _f(rs, 4, 5), _f(rs, 5)], {}),
    "linear_nobias": ([_f(rs, 2, 3, 4), _f(rs, 4, 5)], {}),
    "normalize": ([_f(rs, 3, 5, 2)], {}),
    "normalize_p1": ([_f(rs, 4, 6)], dict(p=1, axis=-1)),
    "cosine_similarity": ([_f(rs, 4, 6), _f(rs, 4, 6)], {}),
    "cosine_similarity_last": ([_f(rs, 2, 3, 5), _f(rs, 2, 3, 5)],
                               dict(axis=-1)),
    "pixel_shuffle": ([_f(rs, 2, 8, 3, 3), 2], {}),
    "pixel_unshuffle": ([_f(rs, 2, 2, 6, 4), 2], {}),
    "channel_shuffle": ([_f(rs, 2, 6, 3, 3), 3], {}),
    "unfold": ([_f(rs, 2, 3, 6, 7), [2, 3]],
               dict(strides=[1, 2], paddings=1, dilations=[1, 2])),
    "fold": ([_f(rs, 2, 12, 42), [5, 6], 2],
             dict(strides=1, paddings=1)),
    "bilinear": ([_f(rs, 4, 3), _f(rs, 4, 5), _f(rs, 2, 3, 5),
                  _f(rs, 1, 2)], {}),
    "label_smooth": ([np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]],
                     dict(epsilon=0.2)),
    "label_smooth_prior": ([np.eye(5, dtype=np.float32)[[2, 3]],
                            np.full((1, 5), 0.2, np.float32)], {}),
    "pad_constant": ([_f(rs, 2, 3, 4, 5), [1, 2, 0, 1]],
                     dict(value=0.5)),
    "pad_reflect": ([_f(rs, 2, 3, 4, 5), [1, 2, 2, 1]],
                    dict(mode="reflect")),
    "pad_replicate": ([_f(rs, 2, 3, 6), [2, 1]], dict(mode="replicate")),
    "pad_every_dim": ([_f(rs, 2, 3, 4), [0, 0, 1, 0, 2, 1]], {}),
    "local_response_norm": ([_f(rs, 2, 7, 4, 4), 5], {}),
    "local_response_norm_even": ([_f(rs, 2, 6, 3), 4],
                                 dict(alpha=1e-2, beta=0.5, k=2.0)),
}


@pytest.mark.parametrize("case", list(COMMON))
def test_common_functional_matches_reference(case):
    arrays, kw = COMMON[case]
    name = case
    for suffix in ("_nobias", "_p1", "_last", "_prior", "_constant",
                   "_reflect", "_replicate", "_every_dim", "_even"):
        name = name.replace(suffix, "")
    _check(name, arrays, kw)


rs = _rs(1)
RESIZE = {
    "nearest_down": dict(size=[3, 4]),
    "nearest_up": dict(scale_factor=2),
    "nearest_odd": dict(scale_factor=[2.5, 1.5]),
    "bilinear_down": dict(size=[3, 4], mode="bilinear"),
    "bilinear_up": dict(size=[14, 20], mode="bilinear"),
    "bilinear_half": dict(scale_factor=0.5, mode="bilinear"),
    "bicubic_up": dict(scale_factor=[2.5, 1.5], mode="bicubic"),
    "bicubic_down": dict(size=[4, 5], mode="bicubic"),
    "area_down": dict(size=[3, 3], mode="area"),
    "one_axis": dict(size=[7, 4], mode="bilinear"),
    "align_corners": dict(size=[11, 13], mode="bilinear",
                          align_corners=True, align_mode=1),
}


@pytest.mark.parametrize("case", list(RESIZE))
def test_interpolate_matches_reference(case):
    _check("interpolate", [_f(_rs(2), 2, 3, 7, 9)], RESIZE[case], tol=CONV)


def test_interpolate_1d_3d_and_upsample_match_reference():
    _check("interpolate", [_f(rs, 2, 3, 8)],
           dict(size=[5], mode="linear", data_format="NCW"), tol=CONV)
    _check("interpolate", [_f(rs, 1, 2, 4, 5, 6)],
           dict(size=[3, 7, 4], mode="trilinear", data_format="NCDHW"),
           tol=CONV)
    _check("upsample", [_f(rs, 2, 3, 5, 5)],
           dict(scale_factor=2, mode="bilinear"), tol=CONV)
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(NotImplementedError):
        TF.interpolate(x, size=[2, 2], data_format="NHWC")
    with pytest.raises(NotImplementedError):
        JF.interpolate(paddle_tpu.to_tensor(x.numpy()), size=[2, 2],
                       data_format="NHWC")


def test_r17_interpolate_is_jax_image_resize_not_torch():
    """R17: the reference's ``interpolate`` is ``jax.image.resize``:
    downsampling 4 -> 2 antialiases (nearest takes ``floor((i + 0.5) *
    2)``), and ``align_corners=True`` changes nothing. The port equals
    ``jax.image.resize`` and the reference, and differs from torch's
    ``interpolate`` exactly where the reference does."""
    x = _f(_rs(3), 2, 3, 4, 4)
    for mode, jmode in (("nearest", "nearest"), ("bilinear", "linear")):
        want = np.asarray(jax.image.resize(x, (2, 3, 2, 2), jmode))
        got = TF.interpolate(torch.from_numpy(x), size=[2, 2],
                             mode=mode).numpy()
        ref = np.asarray(JF.interpolate(paddle_tpu.to_tensor(x), size=[2, 2],
                                        mode=mode).numpy())
        np.testing.assert_allclose(got, want, **CONV)
        np.testing.assert_allclose(ref, want, **CONV)
        kw = {} if mode == "nearest" else dict(align_corners=False)
        torch_own = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=[2, 2], mode=mode, **kw).numpy()
        assert np.abs(got - torch_own).max() > 0.1
    up_ac = TF.interpolate(torch.from_numpy(x), size=[7, 7], mode="bilinear",
                           align_corners=True).numpy()
    up = TF.interpolate(torch.from_numpy(x), size=[7, 7],
                        mode="bilinear").numpy()
    np.testing.assert_array_equal(up_ac, up)
    torch_ac = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=[7, 7], mode="bilinear",
        align_corners=True).numpy()
    assert np.abs(up_ac - torch_ac).max() > 0.1


rs = _rs(4)
TRANSPOSE = {
    "1d": (1, (2, 4, 9), (4, 3, 3), dict(stride=2, padding=1, groups=2)),
    "1d_dilated": (1, (2, 4, 9), (4, 3, 3),
                   dict(stride=3, dilation=2, groups=2)),
    "2d": (2, (2, 4, 6, 7), (4, 3, 3, 2), dict(stride=2, padding=1)),
    "2d_output_padding": (2, (2, 4, 6, 7), (4, 3, 3, 3),
                          dict(stride=2, padding=1, output_padding=1,
                               groups=2)),
    "2d_pairs": (2, (1, 4, 5, 5), (4, 2, 3, 3),
                 dict(stride=2, padding=[1, 0, 2, 1])),
    "2d_same": (2, (1, 4, 5, 6), (4, 2, 3, 3),
                dict(padding="SAME", dilation=2)),
    "2d_valid": (2, (1, 4, 5, 6), (4, 2, 3, 2), dict(padding="VALID")),
    "2d_nhwc": (2, (2, 6, 7, 4), (4, 3, 3, 2),
                dict(stride=2, padding=1, data_format="NHWC")),
    "3d": (3, (1, 4, 4, 5, 3), (4, 2, 3, 2, 2),
           dict(stride=2, padding=1, output_padding=1, groups=2)),
}


@pytest.mark.parametrize("case", list(TRANSPOSE))
def test_conv_transpose_matches_reference(case):
    n, xs, ws, kw = TRANSPOSE[case]
    r = _rs(5)
    groups = kw.get("groups", 1)
    arrays = [_f(r, *xs), _f(r, *ws), _f(r, ws[1] * groups)]
    _check(f"conv{n}d_transpose", arrays, kw, tol=CONV)


def test_r16_conv_transpose_does_not_flip_and_ignores_output_size():
    """R16: both packages' ``conv2d_transpose`` is torch's
    ``conv_transpose2d`` on the spatially flipped weight (grouped too),
    not on the weight as given (Paddle's and torch's own), and
    ``output_size`` changes nothing."""
    r = _rs(6)
    x, w = _f(r, 2, 4, 5, 5), _f(r, 4, 3, 3, 3)
    for groups in (1, 2):
        wg = w if groups == 1 else _f(r, 4, 2, 3, 3)
        got = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(wg),
                                  stride=2, padding=1, groups=groups,
                                  output_size=[10, 10]).numpy()
        ref = np.asarray(JF.conv2d_transpose(
            paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(wg), stride=2,
            padding=1, groups=groups, output_size=[10, 10]).numpy())
        flipped = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(wg[:, :, ::-1, ::-1].copy()),
            stride=2, padding=1, groups=groups).numpy()
        plain = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(wg), stride=2, padding=1,
            groups=groups).numpy()
        assert got.shape == ref.shape == (2, wg.shape[1] * groups, 9, 9)
        np.testing.assert_allclose(got, flipped, **CONV)
        np.testing.assert_allclose(ref, flipped, **CONV)
        assert np.abs(got - plain).max() > 1.0
    with pytest.raises(ValueError):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, padding="SAME")


rs = _rs(7)
_P = 1 / (1 + np.exp(-_f(rs, 6, 5)))
_LOGP = np.log(np.exp(_f(rs, 6, 5)) / np.exp(_f(rs, 6, 5)).sum())
_SIGN = np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
_lsm = torch.log_softmax(torch.from_numpy(_f(rs, 6, 5)), -1).numpy()
_lsm4 = torch.log_softmax(torch.from_numpy(_f(rs, 2, 4, 3, 3)), 1).numpy()
_soft = torch.softmax(torch.from_numpy(_f(rs, 4, 3, 5)), -1).numpy()
LOSSES = {
    "mse_loss": ([_f(rs, 4, 5), _f(rs, 4, 5)], {}),
    "mse_loss_sum": ([_f(rs, 4, 5), _f(rs, 4, 5)], dict(reduction="sum")),
    "l1_loss": ([_f(rs, 4, 5), _f(rs, 4, 5)], dict(reduction="none")),
    "square_error_cost": ([_f(rs, 3, 2), _f(rs, 3, 2)], {}),
    "nll_loss": ([_lsm, np.array([0, 4, 2, -100, 1, 3])],
                 dict(ignore_index=-100)),
    "nll_loss_weight": ([_lsm, np.array([0, 4, 2, 3, 1, 3]),
                         np.abs(_f(rs, 5))], {}),
    "nll_loss_spatial": ([_lsm4, rs.randint(0, 4, (2, 3, 3))],
                         dict(reduction="sum")),
    "binary_cross_entropy": ([_P.astype(np.float32),
                              (rs.rand(6, 5) > 0.5).astype(np.float32)], {}),
    "binary_cross_entropy_weight": (
        [_P.astype(np.float32), rs.rand(6, 5).astype(np.float32),
         np.abs(_f(rs, 6, 5))], dict(reduction="none")),
    "binary_cross_entropy_with_logits": (
        [_f(rs, 6, 5), (rs.rand(6, 5) > 0.5).astype(np.float32)], {}),
    "binary_cross_entropy_with_logits_pos": (
        [_f(rs, 6, 5), rs.rand(6, 5).astype(np.float32),
         np.abs(_f(rs, 6, 5))], dict(pos_weight=np.abs(_f(rs, 5)) + 0.5)),
    "kl_div": ([_LOGP.astype(np.float32), rs.rand(6, 5).astype(np.float32)],
               {}),
    "kl_div_batchmean": ([_LOGP.astype(np.float32),
                          rs.rand(6, 5).astype(np.float32)],
                         dict(reduction="batchmean")),
    "kl_div_log_target": ([_LOGP.astype(np.float32), _f(rs, 6, 5)],
                          dict(log_target=True, reduction="sum")),
    "smooth_l1_loss": ([_f(rs, 6, 5), _f(rs, 6, 5)], dict(delta=0.5)),
    "margin_ranking_loss": ([_f(rs, 6), _f(rs, 6), _SIGN],
                            dict(margin=0.3)),
    "hinge_embedding_loss": ([_f(rs, 6), _SIGN], dict(margin=0.7)),
    "cosine_embedding_loss": ([_f(rs, 6, 4), _f(rs, 6, 4), _SIGN],
                              dict(margin=0.2)),
    "triplet_margin_loss": ([_f(rs, 5, 4), _f(rs, 5, 4), _f(rs, 5, 4)],
                            dict(margin=2.0)),
    "triplet_margin_loss_swap": ([_f(rs, 5, 4), _f(rs, 5, 4), _f(rs, 5, 4)],
                                 dict(p=3.0, swap=True, margin=2.0)),
    "log_loss": ([_P.astype(np.float32),
                  (rs.rand(6, 5) > 0.5).astype(np.float32)], {}),
    "sigmoid_focal_loss": ([_f(rs, 6, 5),
                            (rs.rand(6, 5) > 0.7).astype(np.float32),
                            np.array([3.0], np.float32)], {}),
    "sigmoid_focal_loss_mean": ([_f(rs, 6, 5),
                                 (rs.rand(6, 5) > 0.7).astype(np.float32)],
                                dict(gamma=1.5, reduction="mean")),
    "dice_loss": ([_soft, rs.randint(0, 5, (4, 3, 1))], {}),
    "softmax_with_cross_entropy": ([_f(rs, 6, 5),
                                    rs.randint(0, 5, (6, 1))], {}),
    "softmax_with_cross_entropy_soft": (
        [_f(rs, 6, 5), np.asarray(_soft[0, :2].repeat(3, 0), np.float32)],
        dict(soft_label=True)),
    "softmax_with_cross_entropy_softmax": (
        [_f(rs, 6, 5), rs.randint(0, 5, (6, 1))],
        dict(return_softmax=True)),
    "softmax_with_cross_entropy_ignore": (
        [_f(rs, 6, 5), np.array([[1], [-100], [2], [4], [0], [3]])], {}),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_functional_matches_reference(case):
    arrays, kw = LOSSES[case]
    name = case
    for suffix in ("_sum", "_weight", "_spatial", "_pos", "_batchmean",
                   "_log_target", "_swap", "_mean", "_soft", "_softmax",
                   "_ignore"):
        if name.endswith(suffix) and name[:-len(suffix)] in dir(JF):
            name = name[:-len(suffix)]
    _check(name, arrays, kw)


def test_softmax_with_cross_entropy_takes_the_kernel_route():
    """Hard labels on the last axis go through ``cross_entropy``'s
    softmax-CE path (its plain version on the CPU), so the loss is f32
    with the class axis kept."""
    out = TF.softmax_with_cross_entropy(torch.randn(4, 7, dtype=torch.float64),
                                        torch.tensor([[1], [0], [6], [2]]))
    assert out.shape == (4, 1) and out.dtype == torch.float32


def test_dropouts_agree_in_distribution():
    """The masks come from the port's generators: eval passes ``x``
    through in both packages; in training ``dropout2d`` / ``dropout3d``
    drop whole channels at rate ~p and scale the rest by ``1 / (1 - p)``,
    and ``alpha_dropout`` takes exactly the reference's two affine values
    (``a x + b`` kept, ``a alpha' + b`` dropped) at rate ~p, keeping the
    mean and variance of a unit normal."""
    r = _rs(8)
    x = _f(r, 64, 32, 3, 3)
    for name in ("dropout2d", "alpha_dropout"):
        ref = np.asarray(getattr(JF, name)(paddle_tpu.to_tensor(x), 0.3,
                                           training=False).numpy())
        got = getattr(TF, name)(torch.from_numpy(x), 0.3,
                                training=False).numpy()
        np.testing.assert_array_equal(ref, x)
        np.testing.assert_array_equal(got, x)
    g = torch.Generator().manual_seed(0)
    y = TF.dropout2d(torch.from_numpy(x), 0.3, generator=g).numpy()
    kept = np.abs(y).reshape(64, 32, -1).max(-1) > 0
    np.testing.assert_allclose(y[kept], (x / 0.7)[kept], rtol=1e-6)
    assert abs(1 - kept.mean() - 0.3) < 0.05
    x5 = _f(r, 32, 16, 2, 2, 2)
    y5 = TF.dropout3d(torch.from_numpy(x5), 0.5, generator=g).numpy()
    kept5 = np.abs(y5).reshape(32, 16, -1).max(-1) > 0
    assert abs(kept5.mean() - 0.5) < 0.07
    z = _f(r, 200000)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / ((1 - 0.2) * (1 + 0.2 * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * 0.2
    for out in (TF.alpha_dropout(torch.from_numpy(z), 0.2,
                                 generator=g).numpy(),
                np.asarray(JF.alpha_dropout(paddle_tpu.to_tensor(z),
                                            0.2).numpy())):
        dropped = np.isclose(out, a * alpha_p + b, atol=1e-6)
        np.testing.assert_allclose(out[~dropped], a * z[~dropped] + b,
                                   rtol=1e-5, atol=1e-6)
        assert abs(dropped.mean() - 0.2) < 0.01
        assert abs(out.mean()) < 0.02 and abs(out.std() - 1) < 0.02


# ----------------------------------------------------------------- layers
def _state(jlayer):
    arrays = {n: np.asarray(p.numpy()) for n, p in jlayer.named_parameters()}
    arrays.update({n: np.asarray(b.numpy())
                   for n, b in jlayer.named_buffers()})
    return arrays


def _load(tlayer, jlayer):
    missing, unexpected = tlayer.load_state_dict(
        {k: torch.from_numpy(v) for k, v in _state(jlayer).items()})
    assert not missing and not unexpected
    return tlayer


def _layer_pair(jlayer, tlayer, inputs, tol=TOL, train=False, seed=0):
    """Forward both layers on ``inputs``; the outputs, the input gradients
    and every parameter's gradient of ``sum(out * w)``."""
    for layer in (jlayer, tlayer):
        layer.train() if train else layer.eval()
    jin = [paddle_tpu.to_tensor(a, stop_gradient=a.dtype != np.float32)
           for a in inputs]
    tin = [torch.tensor(a, requires_grad=a.dtype == np.float32)
           for a in inputs]
    jo, to = jlayer(*jin), tlayer(*tin)
    jo = jo[0] if isinstance(jo, tuple) else jo
    to = to[0] if isinstance(to, tuple) else to
    a, b = np.asarray(jo.numpy()), to.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, **tol)
    w = _f(_rs(seed + 50), *a.shape) if a.ndim else np.float32(1.5)
    (jo * paddle_tpu.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(np.asarray(w))).sum().backward()
    for j, t in zip(jin, tin):
        if t.requires_grad:     # a +-1 label: no gradient here, zero there
            tg = np.zeros(t.shape, np.float32) if t.grad is None else \
                t.grad.numpy()
            np.testing.assert_allclose(tg, np.asarray(j.grad.numpy()), **tol)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jlayer.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tlayer.named_parameters()}
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **tol)


rs = _rs(9)
LAYERS = {
    "Conv3D": (lambda: (jnn.Conv3D(4, 6, 3, stride=2, padding=1, groups=2),
                        tnn.Conv3D(4, 6, 3, stride=2, padding=1, groups=2,
                                   device="cpu")),
               [_f(rs, 2, 4, 5, 6, 5)], CONV),
    "Conv1DTranspose": (lambda: (jnn.Conv1DTranspose(4, 6, 3, stride=2),
                                 tnn.Conv1DTranspose(4, 6, 3, stride=2,
                                                     device="cpu")),
                        [_f(rs, 2, 4, 7)], CONV),
    "Conv2DTranspose": (lambda: (jnn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
        tnn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, output_padding=1,
                            groups=2, device="cpu")),
        [_f(rs, 2, 4, 5, 5)], CONV),
    "Conv3DTranspose": (lambda: (jnn.Conv3DTranspose(2, 3, 2, stride=2),
                                 tnn.Conv3DTranspose(2, 3, 2, stride=2,
                                                     device="cpu")),
                        [_f(rs, 1, 2, 3, 4, 3)], CONV),
    "GroupNorm": (lambda: (jnn.GroupNorm(3, 6), tnn.GroupNorm(
        3, 6, device="cpu")), [_f(rs, 2, 6, 4, 3)], TOL),
    "InstanceNorm1D": (lambda: (jnn.InstanceNorm1D(4), tnn.InstanceNorm1D(
        4, device="cpu")), [_f(rs, 3, 4, 7)], TOL),
    "InstanceNorm2D": (lambda: (jnn.InstanceNorm2D(4), tnn.InstanceNorm2D(
        4, device="cpu")), [_f(rs, 3, 4, 5, 6)], TOL),
    "InstanceNorm3D": (lambda: (jnn.InstanceNorm3D(2), tnn.InstanceNorm3D(
        2, device="cpu")), [_f(rs, 2, 2, 3, 4, 3)], TOL),
    "LocalResponseNorm": (lambda: (jnn.LocalResponseNorm(3),
                                   tnn.LocalResponseNorm(3)),
                          [_f(rs, 2, 6, 4, 4)], TOL),
    "Embedding": (lambda: (jnn.Embedding(11, 4, padding_idx=2),
                           tnn.Embedding(11, 4, padding_idx=2,
                                         device="cpu")),
                  [np.array([[1, 2, 3], [2, 10, 0]])], TOL),
    "Bilinear": (lambda: (jnn.Bilinear(3, 5, 4), tnn.Bilinear(
        3, 5, 4, device="cpu")), [_f(rs, 6, 3), _f(rs, 6, 5)], TOL),
    "CosineSimilarity": (lambda: (jnn.CosineSimilarity(axis=-1),
                                  tnn.CosineSimilarity(axis=-1)),
                         [_f(rs, 3, 5), _f(rs, 3, 5)], TOL),
    "Upsample": (lambda: (jnn.Upsample(scale_factor=0.5, mode="bilinear"),
                          tnn.Upsample(scale_factor=0.5, mode="bilinear")),
                 [_f(rs, 2, 3, 8, 6)], CONV),
    "UpsamplingNearest2D": (lambda: (jnn.UpsamplingNearest2D(size=[5, 7]),
                                     tnn.UpsamplingNearest2D(size=[5, 7])),
                            [_f(rs, 2, 3, 4, 4)], TOL),
    "UpsamplingBilinear2D": (lambda: (jnn.UpsamplingBilinear2D(
        scale_factor=2), tnn.UpsamplingBilinear2D(scale_factor=2)),
        [_f(rs, 2, 3, 4, 4)], CONV),
    "Pad1D": (lambda: (jnn.Pad1D([1, 2], mode="reflect"),
                       tnn.Pad1D([1, 2], mode="reflect")),
              [_f(rs, 2, 3, 5)], TOL),
    "Pad2D": (lambda: (jnn.Pad2D([1, 0, 2, 1], value=1.5),
                       tnn.Pad2D([1, 0, 2, 1], value=1.5)),
              [_f(rs, 2, 3, 4, 4)], TOL),
    "Pad3D": (lambda: (jnn.Pad3D([1, 1, 0, 1, 1, 0], mode="replicate"),
                       tnn.Pad3D([1, 1, 0, 1, 1, 0], mode="replicate")),
              [_f(rs, 1, 2, 3, 3, 3)], TOL),
    "Unfold": (lambda: (jnn.Unfold([2, 2], strides=2),
                        tnn.Unfold([2, 2], strides=2)),
               [_f(rs, 2, 3, 4, 6)], TOL),
    "Fold": (lambda: (jnn.Fold([4, 6], [2, 2], strides=2),
                      tnn.Fold([4, 6], [2, 2], strides=2)),
             [_f(rs, 2, 12, 6)], TOL),
    "PixelShuffle": (lambda: (jnn.PixelShuffle(2), tnn.PixelShuffle(2)),
                     [_f(rs, 2, 8, 3, 2)], TOL),
    "PixelUnshuffle": (lambda: (jnn.PixelUnshuffle(2),
                                tnn.PixelUnshuffle(2)),
                       [_f(rs, 2, 2, 4, 6)], TOL),
    "ChannelShuffle": (lambda: (jnn.ChannelShuffle(2),
                                tnn.ChannelShuffle(2)),
                       [_f(rs, 2, 6, 2, 2)], TOL),
    "Dropout2D": (lambda: (jnn.Dropout2D(0.4), tnn.Dropout2D(0.4)),
                  [_f(rs, 2, 6, 2, 2)], TOL),
    "Dropout3D": (lambda: (jnn.Dropout3D(0.4), tnn.Dropout3D(0.4)),
                  [_f(rs, 2, 6, 2, 2, 2)], TOL),
    "AlphaDropout": (lambda: (jnn.AlphaDropout(0.4),
                              tnn.AlphaDropout(0.4)),
                     [_f(rs, 5, 6)], TOL),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_reference(name):
    """Each new layer with the reference's parameters (its state dict,
    loaded with no missing or unexpected key), in eval: outputs, input
    gradients and parameter gradients."""
    make, inputs, tol = LAYERS[name]
    paddle_tpu.seed(3)
    jlayer, tlayer = make()
    _load(tlayer, jlayer)
    _layer_pair(jlayer, tlayer, inputs, tol)


rs = _rs(10)
LOSS_LAYERS = {
    "MSELoss": ([_f(rs, 4, 3), _f(rs, 4, 3)], dict(reduction="sum")),
    "L1Loss": ([_f(rs, 4, 3), _f(rs, 4, 3)], {}),
    "NLLLoss": ([_lsm, np.array([0, 4, 2, 3, 1, 3])], {}),
    "BCELoss": ([_P.astype(np.float32),
                 (rs.rand(6, 5) > 0.5).astype(np.float32)], {}),
    "BCEWithLogitsLoss": ([_f(rs, 6, 5), rs.rand(6, 5).astype(np.float32)],
                          dict(reduction="none")),
    "KLDivLoss": ([_LOGP.astype(np.float32),
                   rs.rand(6, 5).astype(np.float32)],
                  dict(reduction="batchmean")),
    "SmoothL1Loss": ([_f(rs, 6, 5), _f(rs, 6, 5)], dict(delta=0.3)),
    "MarginRankingLoss": ([_f(rs, 6), _f(rs, 6), _SIGN], dict(margin=0.1)),
    "HingeEmbeddingLoss": ([_f(rs, 6), _SIGN], {}),
    "CosineEmbeddingLoss": ([_f(rs, 6, 4), _f(rs, 6, 4), _SIGN], {}),
    "TripletMarginLoss": ([_f(rs, 5, 4), _f(rs, 5, 4), _f(rs, 5, 4)],
                          dict(margin=3.0)),
}


@pytest.mark.parametrize("name", list(LOSS_LAYERS))
def test_loss_layer_matches_reference(name):
    inputs, kw = LOSS_LAYERS[name]
    _layer_pair(getattr(jnn, name)(**kw), getattr(tnn, name)(**kw), inputs)


def test_embedding_and_bilinear_initialise_as_the_reference():
    """``Embedding`` draws ``Normal(0, 1)``; ``Bilinear`` a Xavier-uniform
    weight over the reference's fans (in1 * in2 in, out * in2 out) and a
    zero bias ``[1, out]``."""
    e = tnn.Embedding(400, 50, device="cpu").weight.detach()
    assert abs(e.mean().item()) < 0.02 and abs(e.std().item() - 1) < 0.02
    b = tnn.Bilinear(30, 40, 20, device="cpu")
    limit = (6.0 / (30 * 40 + 20 * 40)) ** 0.5
    w = b.weight.detach()
    assert w.abs().max().item() <= limit and w.abs().max().item() > 0.9 * limit
    assert tuple(b.bias.shape) == (1, 20) and not b.bias.detach().any()
    jb = jnn.Bilinear(30, 40, 20)
    assert {n: tuple(p.shape) for n, p in jb.named_parameters()} == \
        {n: tuple(p.shape) for n, p in b.named_parameters()}


def test_spectral_norm_raises_in_both_packages():
    with pytest.raises(NotImplementedError):
        jnn.SpectralNorm([4, 3])
    with pytest.raises(NotImplementedError):
        tnn.SpectralNorm([4, 3])


def test_sync_batch_norm_is_batch_norm_on_one_process():
    """Training forward, gradients and running buffers equal the
    reference's ``SyncBatchNorm`` (batch norm on one process); with
    ``torch.distributed`` over two ranks its training forward raises, as
    the reference's eager multi-process one does;
    ``convert_sync_batchnorm`` swaps every batch norm of a model in place,
    keeping its parameters and buffers."""
    paddle_tpu.seed(4)
    j = jnn.SyncBatchNorm(5)
    t = _load(tnn.SyncBatchNorm(5, device="cpu"), j)
    x = _f(_rs(11), 4, 5, 3, 3)
    _layer_pair(j, t, [x], train=True)
    for n, b in j.named_buffers():
        np.testing.assert_allclose(t.get_buffer(n).numpy(),
                                   np.asarray(b.numpy()), err_msg=n, **TOL)
    with pytest.MonkeyPatch.context() as mp:       # two ranks: it raises
        mp.setattr(torch.distributed, "is_initialized", lambda: True)
        mp.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        with pytest.raises(NotImplementedError):
            t(torch.from_numpy(x))
        t.eval()
        t(torch.from_numpy(x))          # eval reads the running buffers
    model = tnn.Sequential(tnn.Conv2D(3, 5, 1, device="cpu"),
                           tnn.BatchNorm2D(5, device="cpu"))
    bn = model[1]
    tnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert type(model[1]) is tnn.SyncBatchNorm and model[1] is bn


def test_nn_surface_cases_cover_every_new_name_and_run_on_the_cpu():
    """``tools/nn_surface_cases.py`` (the card's ``[nn surface]`` phase and
    ``tests/test_torch_cuda.py``) names every one of the 36 functionals
    and 44 layers this slice added, holds a case for each but the two
    that cannot run (``RNNCellBase``, the cells' base, and
    ``SpectralNorm``, which raises), and every case runs on the CPU with
    finite outputs and gradients, the same twice."""
    from tools import nn_surface_cases as S

    assert len(S.FUNCTIONALS) == 36 and len(S.LAYERS) == 44
    assert set(S.FUNCTIONALS) | set(S.LAYERS) <= \
        set(dir(TF)) | set(dir(tnn))
    cases = S.cases()
    names = {c[1] for c in cases}
    assert names == set(S.FUNCTIONALS) | set(S.LAYERS) - {
        "RNNCellBase", "SpectralNorm"}
    for case in cases:
        a, b = S.run(torch, case, "cpu"), S.run(torch, case, "cpu")
        assert a and all(np.isfinite(x).all() for x in a), case[1]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
