"""The Conformer-CTC slice of the PyTorch port (paddle_tpu_torch) against
the JAX package, on the CPU.

Every comparison feeds both packages the same numpy inputs; the models
share weights through ``conformer_state_from_jax`` (parameters and the
batch norms' running buffers), never a re-initialisation. Tolerances
(f32 on both sides; XLA and torch sum in different orders):

- activations, layer outputs and log-probs: atol 1e-5, rtol 1e-5;
- losses and gradients: atol = rtol = 1e-4. A few gradients are 0 in
  exact arithmetic (the key projections' biases, which the softmax
  cancels, and the depthwise conv biases, which training-mode batch norm
  cancels): each side holds rounding noise of ~1e-7 there, which the
  absolute part covers;
- the CTC lattice: the port's plain version against the reference's scan
  lattice (``set_use_pallas(False)``) and its Pallas kernels in interpret
  mode (``ctc_loss_pallas``, as ``tests/test_ctc_pallas.py`` runs it):
  losses rtol 1e-5 (atol 1e-4); gradients (posteriors in [0, 1])
  atol = rtol = 1e-4, since ``exp(alpha + beta - ll)`` carries the f32
  rounding of exponents of size |ll| (~2 per frame): ~1e-5 relative at
  T = 30.

One deliberate difference is tested as such: an utterance with no
feasible alignment has loss 1e30 in both packages, but the port's
gradient there is exactly 0, where the reference's is an f32 cancellation
artefact (``kernels/ctc.py``); the feasible rows are compared.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.kernels import set_use_pallas
from paddle_tpu.kernels.ctc import ctc_loss_pallas
from paddle_tpu.models import ConformerForCTC as JConformer
from paddle_tpu.models import ConformerConfig as JConfig
from paddle_tpu.models import conformer_tiny as j_conformer_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels.ctc import (ctc_alpha_plain, ctc_beta_plain,
                                          ctc_lattice)
from paddle_tpu_torch.models import (ConformerConfig, ConformerForCTC,
                                     conformer_state_from_jax, conformer_tiny)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return paddle_tpu.to_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_case(T, B, C, L, seed):
    """Seeded log-probs and labels: ragged lengths, a row with repeated
    adjacent labels, an empty label (row 2) and an infeasible row (row 3:
    L equal labels need 2L - 1 frames, it gets L + 2)."""
    rng = np.random.RandomState(seed)
    logits = 2 * rng.randn(T, B, C).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.randint(1, C, (B, L)).astype(np.int32)
    in_len = rng.randint(3 * T // 4, T + 1, B).astype(np.int32)
    lbl_len = rng.randint(L // 2, L + 1, B).astype(np.int32)
    in_len[0], lbl_len[0] = T, L
    labels[1, 1:4] = labels[1, 0]                  # repeats
    lbl_len[2] = 0                                 # empty label
    labels[3] = 1 + seed % (C - 1)
    lbl_len[3], in_len[3] = L, L + 2               # infeasible
    return lp.astype(np.float32), labels, in_len, lbl_len


CTC_CASES = [(14, 5, 7, 4), (30, 6, 9, 6), (90, 4, 11, 66)]   # S = 133 last


def _port_ctc(lp, labels, in_len, lbl_len, reduction, norm_by_times):
    x = _t(lp).requires_grad_()
    loss = TF.ctc_loss(x, _t(labels), _t(in_len), _t(lbl_len),
                       reduction=reduction, norm_by_times=norm_by_times)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _scan_ctc(lp, labels, in_len, lbl_len, reduction, norm_by_times):
    set_use_pallas(False)
    try:
        z = paddle_tpu.to_tensor(lp, stop_gradient=False)
        loss = JF.ctc_loss(z, _j(labels), _j(in_len), _j(lbl_len),
                           reduction=reduction, norm_by_times=norm_by_times)
        loss.sum().backward()
        return np.asarray(loss.numpy()), np.asarray(z.grad.numpy())
    finally:
        set_use_pallas(None)


def _reduce(x, reduction):
    return x.mean() if reduction == "mean" else (
        x.sum() if reduction == "sum" else x)


def _pallas_ctc(lp, labels, in_len, lbl_len, reduction, norm_by_times):
    """The reference's Pallas lattice (interpret mode on the CPU), with the
    functional's normalisation and reduction around it."""
    import jax

    def f(x):
        loss = ctc_loss_pallas(x, jnp.asarray(labels), jnp.asarray(in_len),
                               jnp.asarray(lbl_len), 0)
        if norm_by_times:
            loss = loss / jnp.maximum(jnp.asarray(in_len, jnp.float32), 1.0)
        return _reduce(loss, reduction)

    x = jnp.asarray(lp)
    return (np.asarray(f(x)),
            np.asarray(jax.grad(lambda y: jnp.sum(f(y)))(x)))


@pytest.mark.parametrize("shape", CTC_CASES)
@pytest.mark.parametrize("reduction,norm", [("none", False), ("mean", False),
                                            ("sum", False), ("mean", True)])
def test_ctc_loss_and_grad_match_scan_lattice(shape, reduction, norm):
    lp, labels, in_len, lbl_len = _ctc_case(*shape, seed=shape[0])
    loss, grad = _port_ctc(lp, labels, in_len, lbl_len, reduction, norm)
    ref_loss, ref_grad = _scan_ctc(lp, labels, in_len, lbl_len, reduction,
                                   norm)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, atol=1e-4)
    feasible = [b for b in range(shape[1]) if b != 3]
    np.testing.assert_allclose(grad[:, feasible], ref_grad[:, feasible],
                               **TOL)
    assert not grad[:, 3].any()            # the infeasible row: exactly 0


@pytest.mark.parametrize("shape", CTC_CASES)
@pytest.mark.parametrize("reduction,norm", [("none", False), ("mean", True)])
def test_ctc_loss_and_grad_match_pallas_interpret(shape, reduction, norm):
    lp, labels, in_len, lbl_len = _ctc_case(*shape, seed=shape[0] + 1)
    loss, grad = _port_ctc(lp, labels, in_len, lbl_len, reduction, norm)
    ref_loss, ref_grad = _pallas_ctc(lp, labels, in_len, lbl_len, reduction,
                                     norm)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, atol=1e-4)
    feasible = [b for b in range(shape[1]) if b != 3]
    np.testing.assert_allclose(grad[:, feasible], ref_grad[:, feasible],
                               **TOL)


def test_ctc_infeasible_row_loss_and_zero_gradient():
    lp, labels, in_len, lbl_len = _ctc_case(14, 5, 7, 4, seed=3)
    loss, grad = _port_ctc(lp, labels, in_len, lbl_len, "none", False)
    ref_loss, _ = _pallas_ctc(lp, labels, in_len, lbl_len, "none", False)
    assert loss[3] == ref_loss[3] == np.float32(1e30)
    assert not grad[:, 3].any() and np.abs(grad[:, 0]).max() > 0.1


def test_ctc_plain_lattices_match_torch_and_each_other():
    """alpha's log-likelihood equals torch's CTC on the feasible rows, and
    the two lattices agree: logsumexp_s(alpha + beta) = ll at every t <
    in_len (the forward-backward identity)."""
    lp, labels, in_len, lbl_len = _ctc_case(30, 6, 9, 6, seed=5)
    args = (_t(lp), _t(labels), _t(in_len), _t(lbl_len))
    alphas, ll = ctc_alpha_plain(*args)
    betas = ctc_beta_plain(*args)
    ref = torch.nn.functional.ctc_loss(
        args[0], args[1].long(), args[2].long(), args[3].long(),
        reduction="none")
    feasible = [b for b in range(6) if b != 3]
    np.testing.assert_allclose(-ll[feasible].numpy(), ref[feasible].numpy(),
                               rtol=1e-5)
    tot = torch.logsumexp(alphas + betas, dim=2)          # [T, B]
    for b in feasible:
        np.testing.assert_allclose(tot[:in_len[b], b].numpy(),
                                   np.full(in_len[b], ll[b].item()),
                                   rtol=1e-5)
        assert (betas[in_len[b]:, b] == -1e30).all()


def test_ctc_all_labels_empty():
    """L = 0 (S = 1): the only path is all blanks, so the loss is
    ``-sum_{t < in_len} log_probs[t, b, blank]`` and the gradient -1 there
    (0 past in_len and at the other classes)."""
    rng = np.random.RandomState(8)
    T, B, C = 9, 3, 5
    logits = rng.randn(T, B, C).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    in_len = np.array([9, 6, 1], np.int32)
    labels = np.zeros((B, 0), np.int32)
    loss, grad = _port_ctc(lp, labels, in_len, np.zeros(B, np.int32), "none",
                           False)
    want = np.array([-lp[:n, b, 0].sum() for b, n in enumerate(in_len)])
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    want_grad = np.zeros_like(lp)
    for b, n in enumerate(in_len):
        want_grad[:n, b, 0] = -1.0
    np.testing.assert_allclose(grad, want_grad, atol=1e-5)


def test_ctc_loss_layer_and_label_dtypes():
    lp, labels, in_len, lbl_len = _ctc_case(14, 5, 7, 4, seed=7)
    layer = tnn.CTCLoss(blank=0, reduction="sum")
    got = layer(_t(lp), _t(labels).long(), _t(in_len).long(),
                _t(lbl_len).long())
    want = TF.ctc_loss(_t(lp), _t(labels), _t(in_len), _t(lbl_len),
                       reduction="sum")
    assert got.dtype == torch.float32 and got.item() == want.item()
    jl = jnn.CTCLoss(blank=0, reduction="sum")(
        _j(lp), _j(labels), _j(in_len), _j(lbl_len))
    np.testing.assert_allclose(got.item(), float(jl.numpy()), rtol=1e-5)
    assert ctc_lattice(_t(lp), _t(labels), _t(in_len),
                       _t(lbl_len)).shape == (5,)


# ---------------------------------------------------------------------------
# activations, convolutions, batch norm
# ---------------------------------------------------------------------------

def test_swish_glu_log_softmax_match_reference():
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(3, 8, 10)).astype(np.float32)
    np.testing.assert_allclose(TF.swish(_t(x)).numpy(),
                               JF.swish(_j(x)).numpy(), **ACT)
    for axis in (1, -1):
        np.testing.assert_allclose(TF.glu(_t(x), axis=axis).numpy(),
                                   JF.glu(_j(x), axis=axis).numpy(), **ACT)
        np.testing.assert_allclose(TF.log_softmax(_t(x), axis=axis).numpy(),
                                   JF.log_softmax(_j(x), axis=axis).numpy(),
                                   **ACT)


def _conv_pair(jcls, tcls, seed, *args, **kw):
    paddle_tpu.seed(seed)
    jl = jcls(*args, **kw)
    tl = tcls(*args, **kw, device="cpu")
    tl.load_state_dict({n: _t(np.asarray(p._value))
                        for n, p in jl.named_parameters()})
    return jl, tl


@pytest.mark.parametrize("case", ["conv1d_depthwise", "conv2d_stride2"])
def test_conv_layers_match_reference(case):
    rng = np.random.RandomState(1)
    if case == "conv1d_depthwise":
        jl, tl = _conv_pair(jnn.Conv1D, tnn.Conv1D, 1, 12, 12, 7, padding=3,
                            groups=12)
        x = rng.randn(2, 12, 19).astype(np.float32)
    else:
        jl, tl = _conv_pair(jnn.Conv2D, tnn.Conv2D, 2, 3, 8, 3, stride=2,
                            padding=1)
        x = rng.randn(2, 3, 17, 10).astype(np.float32)
    jx = paddle_tpu.to_tensor(x, stop_gradient=False)
    jy = jl(jx)
    tx = _t(x).requires_grad_()
    ty = tl(tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **ACT)
    w = rng.randn(*jy.shape).astype(np.float32)
    (jy * _j(w)).sum().backward()
    (ty * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), dict(jl.named_parameters())[n].grad.numpy(),
            err_msg=n, **TOL)


def test_conv_functionals_keep_paddle_padding_and_layout():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 4).astype(np.float32)            # NLC
    w = rng.randn(6, 4, 3).astype(np.float32)
    for pad in ("SAME", "VALID", [1, 2], 1):
        got = TF.conv1d(_t(x), _t(w), padding=pad, data_format="NLC")
        want = JF.conv1d(_j(x), _j(w), padding=pad, data_format="NLC")
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=pad,
                                   **ACT)


def test_conv_init_is_paddles():
    layer = tnn.Conv1D(8, 16, 5, groups=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    fan_in = 8 // 2 * 5
    assert layer.weight.shape == (16, 4, 5)
    assert layer.weight.abs().max() <= (6 / fan_in) ** 0.5
    assert layer.bias.abs().max() <= 1 / fan_in ** 0.5
    assert layer.weight.std() > 0.5 * (2 / fan_in) ** 0.5


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_1d_matches_reference(training):
    rng = np.random.RandomState(3)
    paddle_tpu.seed(3)
    jl = jnn.BatchNorm1D(6)
    tl = tnn.BatchNorm1D(6, device="cpu")
    params = {"weight": 1 + 0.2 * rng.randn(6), "bias": 0.3 * rng.randn(6),
              "_mean": 0.1 * rng.randn(6), "_variance": 1 + rng.rand(6)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    for k, v in params.items():
        getattr(jl, k)._value = jnp.asarray(v)
    tl.load_state_dict({k: _t(v) for k, v in params.items()})
    if not training:
        jl.eval()
        tl.eval()
    x = (2 * rng.randn(4, 6, 11) + 0.5).astype(np.float32)
    jx = paddle_tpu.to_tensor(x, stop_gradient=False)
    tx = _t(x).requires_grad_()
    jy, ty = jl(jx), tl(tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **ACT)
    w = rng.randn(4, 6, 11).astype(np.float32)
    (jy * _j(w)).sum().backward()
    (ty * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    for n in ("weight", "bias"):
        np.testing.assert_allclose(getattr(tl, n).grad.numpy(),
                                   getattr(jl, n).grad.numpy(), **TOL)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tl, n).numpy(),
                                   np.asarray(getattr(jl, n)._value), **ACT)
    moved = not np.allclose(tl._mean.numpy(), params["_mean"])
    assert moved == training


def test_layer_list_is_a_module_list():
    ll = tnn.LayerList([tnn.Dropout(0.1), tnn.Dropout(0.2)])
    assert isinstance(ll, torch.nn.ModuleList) and len(ll) == 2
    assert [n for n, _ in ll.named_children()] == ["0", "1"]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CONFIGS = {"tiny": dict(),
           "head_dim_36": dict(vocab=40, hidden=72, layers=2, heads=2)}


def _models(seed, **cfg):
    paddle_tpu.seed(seed)
    jm = JConformer(j_conformer_tiny(**cfg))
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    arrays.update({n: np.asarray(b._value) for n, b in jm.named_buffers()})
    tm = ConformerForCTC(conformer_tiny(**cfg), device="cpu")
    missing, unexpected = tm.load_state_dict(
        conformer_state_from_jax(arrays, tm))
    assert not missing and not unexpected
    return jm, tm


def _batch(seed, vocab, B=2, T=40, feat=16):
    rng = np.random.RandomState(seed)
    feats = rng.rand(B, T, feat).astype(np.float32)
    labels = rng.randint(1, vocab, (B, 4)).astype(np.int32)
    return feats, labels


def _tgrads(tm):
    out = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        owner = tm.get_submodule(n.rpartition(".")[0])
        out[n] = g.T if isinstance(owner, torch.nn.Linear) and \
            n.endswith("weight") else g
    return out


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_conformer_logprobs_and_grads_match_reference(cfg):
    jm, tm = _models(4, **CONFIGS[cfg])
    vocab = tm.cfg.vocab_size
    assert tm.cfg.hidden // tm.cfg.num_heads == (36 if cfg != "tiny" else 16)
    feats, labels = _batch(4, vocab)
    jlp = jm(_j(feats))
    tlp = tm(_t(feats))
    np.testing.assert_allclose(tlp.detach().numpy(), jlp.numpy(), **ACT)
    T = tlp.shape[0]
    in_len = np.array([T, T - 2], np.int64)
    lbl_len = np.array([4, 3], np.int64)
    set_use_pallas(False)
    try:
        jloss = JF.ctc_loss(jlp, _j(labels), _j(in_len), _j(lbl_len))
        jloss.backward()
    finally:
        set_use_pallas(None)
    tloss = TF.ctc_loss(tlp, _t(labels), _t(in_len), _t(lbl_len))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), **TOL)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tg = _tgrads(tm)
    assert set(tg) == set(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
    for n, b in jm.named_buffers():           # the BN running statistics
        np.testing.assert_allclose(tm.get_buffer(n).numpy(),
                                   np.asarray(b._value), err_msg=n, **ACT)


def test_conformer_three_adamw_steps_match_reference():
    """As the reference's ``TestConformer.test_ctc_head_trains``, with
    AdamW: the same loss sequence."""
    jm, tm = _models(5)
    feats, labels = _batch(5, 32)
    jopt = JAdamW(learning_rate=3e-3, parameters=jm.parameters(),
                  weight_decay=0.01)
    topt = AdamW(learning_rate=3e-3, parameters=tm.parameters(),
                 weight_decay=0.01)
    in_len = np.full(2, 10, np.int64)
    lbl_len = np.full(2, 4, np.int64)
    jl, tl = [], []
    set_use_pallas(False)
    try:
        for _ in range(3):
            loss = JF.ctc_loss(jm(_j(feats)), _j(labels), _j(in_len),
                               _j(lbl_len))
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss.numpy()))
    finally:
        set_use_pallas(None)
    for _ in range(3):
        loss = TF.ctc_loss(tm(_t(feats)), _t(labels), _t(in_len),
                           _t(lbl_len))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


def test_converter_covers_every_parameter_and_buffer():
    paddle_tpu.seed(6)
    jm = JConformer(j_conformer_tiny())
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    buffers = {n: np.asarray(b._value) for n, b in jm.named_buffers()}
    tm = ConformerForCTC(conformer_tiny(), device="cpu")
    st = conformer_state_from_jax({**arrays, **buffers}, tm)
    assert set(st) == set(tm.state_dict()) == set(arrays) | set(buffers)
    assert {n.rpartition(".")[2] for n in buffers} == {"_mean", "_variance"}
    linears = {n for n, m in tm.named_modules()
               if isinstance(m, torch.nn.Linear)}
    # the converter keeps the reference's layouts (F4); loading transposes
    # exactly the plain torch Linears' weights into torch's layout
    tm.load_state_dict(st)
    raw = torch.nn.Module.state_dict(tm)
    for name, a in {**arrays, **buffers}.items():
        owner = name.rpartition(".")[0]
        want = a.T if owner in linears and name.endswith("weight") else a
        np.testing.assert_array_equal(st[name].numpy(), a, err_msg=name)
        np.testing.assert_array_equal(raw[name].numpy(), want, err_msg=name)
    assert st["encoder.blocks.0.conv.dw.weight"].shape == (32, 1, 7)
    with pytest.raises(KeyError):
        conformer_state_from_jax({"nope.weight": arrays["head.bias"]}, tm)


def test_conformer_config_defaults_are_the_reference():
    assert vars(ConformerConfig()) == vars(JConfig())
    assert vars(conformer_tiny(vocab=9)) == vars(j_conformer_tiny(vocab=9))


def test_conformer_refuses_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConformerForCTC(conformer_tiny())


def test_conformer_slice_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch import amp\n"
        "from paddle_tpu_torch.models import ConformerForCTC, conformer_tiny\n"
        "from paddle_tpu_torch.nn.functional import ctc_loss\n"
        "cfg = conformer_tiny()\n"
        "cfg.dropout = 0.1\n"
        "m = ConformerForCTC(cfg, device='cpu', seed=0)\n"
        "x = torch.rand(2, 32, 16)\n"
        "with amp.auto_cast(level='O1'):\n"
        "    lp = m(x)\n"
        "loss = ctc_loss(lp, torch.tensor([[1, 2], [3, 3]]),\n"
        "                torch.tensor([8, 7]), torch.tensor([2, 2]))\n"
        "loss.backward()\n"
        "print('ok', lp.dtype, round(loss.item(), 3))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok torch.float32")
