"""The Conformer-Transducer (RNN-T) slice of the PyTorch port
(paddle_tpu_torch) against the JAX package, on the CPU.

Every comparison feeds both packages the same numpy inputs; the models
share weights converted from the reference (``conformer_state_from_jax``
for the model, the parameter arrays as they are for the LSTM), never a
re-initialisation. Tolerances (f32 on both sides; XLA and torch sum in
different orders):

- the LSTM: outputs, ``h_n``, ``c_n`` and every gradient at atol 1e-5
  (rtol 1e-5);
- ``rnnt_loss`` against the reference's scan lattice
  (``set_use_pallas(False)``): losses rtol 1e-5 (atol 1e-5), logit
  gradients atol 1e-5; against its Pallas kernels in interpret mode
  (``set_use_pallas(True)``, as ``tests/test_rnnt_pallas.py`` runs them):
  rtol 1e-4 (atol 1e-5), the reference's own test's limit; against the
  float64 brute-force oracle ``tests.test_asr._brute_rnnt``: rtol 1e-5;
- the model: logits atol 1e-5, losses and gradients atol = rtol = 1e-4
  as in the Conformer-CTC tests (a few gradients are 0 in exact
  arithmetic and hold rounding noise on each side).

R4 is tested as such: the reference's FastEmit adds ``log1p(lambda)`` to
every emit log-prob, so each loss shifts by exactly ``-u_len *
log1p(lambda)`` and every gradient equals lambda = 0's (to f32 rounding,
atol 1e-5); the port reproduces it.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu.kernels import set_use_pallas
from paddle_tpu.models import ConformerForRNNT as JRNNT
from paddle_tpu.models import conformer_tiny as j_conformer_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels.rnnt import (NEG, rnnt_alpha_plain,
                                           rnnt_beta_grad_plain, rnnt_lattice)
from paddle_tpu_torch.models import (ConformerForRNNT,
                                     conformer_state_from_jax, conformer_tiny)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW
from tests.test_asr import _brute_rnnt

torch.set_num_threads(1)
LSTM_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _j(a, grad=False):
    return paddle_tpu.to_tensor(np.ascontiguousarray(a),
                                stop_gradient=not grad)


# ---------------------------------------------------------------------------
# LSTMCell, LSTM
# ---------------------------------------------------------------------------

def _lstm_pair(seed, *args, **kw):
    paddle_tpu.seed(seed)
    jl = jnn.LSTM(*args, **kw)
    tl = tnn.LSTM(*args, **kw, device="cpu")
    names = [n for n, _ in jl.named_parameters()]
    assert sorted(tl.state_dict()) == sorted(names)
    tl.load_state_dict({n: _t(p._value) for n, p in jl.named_parameters()})
    return jl, tl


LSTM_CASES = {
    "1 layer": dict(num_layers=1),
    "2 layers, lengths": dict(num_layers=2, lengths=True),
    "bidirect, time major, lengths": dict(direction="bidirect",
                                          time_major=True, lengths=True),
    "2 layers bidirect, initial states": dict(num_layers=2,
                                              direction="bidirect",
                                              init=True),
}


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_matches_reference(case):
    kw = dict(LSTM_CASES[case])
    lengths, init = kw.pop("lengths", False), kw.pop("init", False)
    B, T, n_in, H = 3, 7, 5, 6
    jl, tl = _lstm_pair(11, n_in, H, **kw)
    nd = 2 if kw.get("direction") == "bidirect" else 1
    L = kw.get("num_layers", 1)
    rng = np.random.RandomState(1)
    shape = (T, B, n_in) if kw.get("time_major") else (B, T, n_in)
    x = rng.randn(*shape).astype(np.float32)
    seq = np.array([7, 4, 1], np.int64) if lengths else None
    h0 = 0.5 * rng.randn(L * nd, B, H).astype(np.float32) if init else None
    c0 = 0.5 * rng.randn(L * nd, B, H).astype(np.float32) if init else None

    jx = _j(x, grad=True)
    jinit = (_j(h0, True), _j(c0, True)) if init else None
    jo, (jh, jc) = jl(jx, jinit, None if seq is None else _j(seq))
    tx = _t(x).requires_grad_()
    tinit = (_t(h0).requires_grad_(), _t(c0).requires_grad_()) \
        if init else None
    to, (th, tc) = tl(tx, tinit, None if seq is None else _t(seq))
    assert tuple(th.shape) == (L * nd, B, H) == tuple(jh.shape)
    for got, want in ((to, jo), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   **LSTM_TOL)
    if seq is not None:   # padded steps emit zeros (row 2 has 1 step)
        out = to.detach().numpy()
        assert not (out[1:, 2] if kw.get("time_major") else out[2, 1:]).any()
    w = [rng.randn(*o.shape).astype(np.float32) for o in (jo, jh, jc)]
    (sum((o * _j(wi)).sum() for o, wi in zip((jo, jh, jc), w))).backward()
    (sum((o * _t(wi)).sum() for o, wi in zip((to, th, tc), w))).backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **LSTM_TOL)
    if init:
        for tt, jt in zip(tinit, jinit):
            np.testing.assert_allclose(tt.grad.numpy(), jt.grad.numpy(),
                                       **LSTM_TOL)
    jg = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n].grad.numpy(),
                                   err_msg=n, **LSTM_TOL)


def test_lstm_cell_matches_reference():
    paddle_tpu.seed(3)
    jc = jnn.LSTMCell(4, 5)
    tc = tnn.LSTMCell(4, 5, device="cpu")
    tc.load_state_dict({n: _t(p._value) for n, p in jc.named_parameters()})
    rng = np.random.RandomState(3)
    x, h, c = (rng.randn(2, n).astype(np.float32) for n in (4, 5, 5))
    jx, jh, jcs = _j(x, True), _j(h, True), _j(c, True)
    jo, (jh2, jc2) = jc(jx, (jh, jcs))
    tx, th, tcs = (_t(a).requires_grad_() for a in (x, h, c))
    to, (th2, tc2) = tc(tx, (th, tcs))
    for got, want in ((to, jo), (th2, jh2), (tc2, jc2)):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   **LSTM_TOL)
    (jh2.sum() + 2 * jc2.sum()).backward()
    (th2.sum() + 2 * tc2.sum()).backward()
    for got, want in ((tx, jx), (th, jh), (tcs, jcs)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   **LSTM_TOL)
    jg = dict(jc.named_parameters())
    for n, p in tc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n].grad.numpy(),
                                   err_msg=n, **LSTM_TOL)
    zo, _ = tc(tx)                       # default states: zeros
    np.testing.assert_allclose(
        zo.detach().numpy(), jc(jx)[0].numpy(), **LSTM_TOL)


def test_lstm_init_and_a_custom_cell_takes_the_step_loop():
    """Weights ``Uniform(+-1/sqrt(H))`` from the generator; an RNN over a
    cell that is not an ``LSTMCell`` runs the cell step by step with the
    same masking, and agrees with the hoisted-GEMM loop."""
    g = torch.Generator().manual_seed(0)
    cell = tnn.LSTMCell(4, 16, device="cpu", generator=g)
    for p in cell.parameters():
        assert p.abs().max() <= 0.25 and p.std() > 0.1

    class Wrapped(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def get_initial_states(self, x, batch_dim_idx=0):
            return self.inner.get_initial_states(x, batch_dim_idx)

        def forward(self, x, states):
            return self.inner(x, states)

    x = torch.randn(3, 6, 4, generator=g)
    seq = torch.tensor([6, 2, 4])
    for rev in (False, True):
        fast = tnn.RNN(cell, is_reverse=rev)(x, sequence_length=seq)
        slow = tnn.RNN(Wrapped(cell), is_reverse=rev)(x, sequence_length=seq)
        torch.testing.assert_close(slow[0], fast[0])
        for a, b in zip(slow[1], fast[1]):
            torch.testing.assert_close(a, b)
        assert not fast[0][1, 2:].any()


def test_lstm_dropout_between_layers_only_in_training():
    lstm = tnn.LSTM(4, 8, num_layers=2, dropout=0.5, device="cpu")
    x = torch.randn(2, 5, 4)
    a, b = lstm(x)[0], lstm(x)[0]
    assert not torch.equal(a, b)         # fresh masks between the layers
    lstm.eval()
    torch.testing.assert_close(lstm(x)[0], lstm(x)[0], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# rnnt_loss
# ---------------------------------------------------------------------------

def _rnnt_case(B, T, U, V, seed):
    """Seeded logits and labels with ragged lengths: row 0 full, and where
    B > 2, ``u_len = 0`` (row 1) and ``t_len = 1`` (row 2)."""
    rng = np.random.RandomState(seed)
    logits = 2 * rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    tl = rng.randint(1, T + 1, B).astype(np.int32)
    ul = rng.randint(0, U + 1, B).astype(np.int32)
    tl[0], ul[0] = T, U
    if B > 2:
        ul[1], tl[2] = 0, 1
    return logits, labels, tl, ul


def _port_rnnt(logits, labels, tl, ul, **kw):
    x = _t(logits).requires_grad_()
    loss = TF.rnnt_loss(x, _t(labels), _t(tl), _t(ul), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _ref_rnnt(logits, labels, tl, ul, pallas, **kw):
    set_use_pallas(pallas)
    try:
        z = _j(logits, grad=True)
        loss = JF.rnnt_loss(z, _j(labels), _j(tl), _j(ul), **kw)
        loss.sum().backward()
        return np.asarray(loss.numpy()), np.asarray(z.grad.numpy())
    finally:
        set_use_pallas(None)


RNNT_SHAPES = [(4, 7, 5, 6), (3, 12, 9, 11)]


@pytest.mark.parametrize("shape", RNNT_SHAPES)
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_rnnt_loss_and_grad_match_scan_lattice(shape, reduction, lam):
    args = _rnnt_case(*shape, seed=shape[1])
    blank = 0 if reduction != "sum" else 3
    kw = dict(blank=blank, fastemit_lambda=lam, reduction=reduction)
    loss, grad = _port_rnnt(*args, **kw)
    ref_loss, ref_grad = _ref_rnnt(*args, pallas=False, **kw)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", RNNT_SHAPES)
@pytest.mark.parametrize("blank,lam", [(0, 0.0), (2, 0.01)])
def test_rnnt_loss_and_grad_match_pallas_interpret(shape, blank, lam):
    args = _rnnt_case(*shape, seed=shape[1] + 1)
    kw = dict(blank=blank, fastemit_lambda=lam, reduction="none")
    loss, grad = _port_rnnt(*args, **kw)
    ref_loss, ref_grad = _ref_rnnt(*args, pallas=True, **kw)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("blank", [0, 4])
def test_rnnt_loss_matches_brute_oracle(blank):
    logits, labels, tl, ul = _rnnt_case(4, 6, 4, 7, seed=21 + blank)
    labels[labels == blank] = 1
    loss, _ = _port_rnnt(logits, labels, tl, ul, blank=blank,
                         reduction="none")
    for b in range(4):
        lp = np.asarray(logits[b], np.float64)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        want = _brute_rnnt(lp[:tl[b], :ul[b] + 1], list(labels[b][:ul[b]]),
                           blank=blank)
        np.testing.assert_allclose(loss[b], want, rtol=1e-5)


def test_fastemit_shifts_the_loss_and_keeps_the_gradients():
    """R4: the reference's FastEmit adds ``log1p(lambda)`` to every emit
    log-prob; every complete path takes ``u_len`` emits, so the loss moves
    by ``-u_len * log1p(lambda)`` and no gradient changes (Yu et al.'s
    FastEmit would scale the emit gradient instead)."""
    args = _rnnt_case(4, 9, 6, 8, seed=4)
    ul = args[3]
    l0, g0 = _port_rnnt(*args, reduction="none")
    for lam in (0.01, 0.5):
        l1, g1 = _port_rnnt(*args, reduction="none", fastemit_lambda=lam)
        np.testing.assert_allclose(l1 - l0, -ul * np.log1p(lam), atol=1e-5)
        np.testing.assert_allclose(g1, g0, atol=1e-5, rtol=0)
        r1, _ = _ref_rnnt(*args, pallas=False, reduction="none",
                          fastemit_lambda=lam)
        np.testing.assert_allclose(l1, r1, rtol=1e-5, atol=1e-5)


def test_rnnt_plain_lattices_dead_cells_and_path_identities():
    """Cells outside ``t < t_len, u <= u_len`` are -1e30 (alpha, bhat) and
    0 (posteriors); ``bhat[0, 0] = ll``; every path takes exactly one blank
    at each ``t < t_len`` and emits each label once, so the blank
    posteriors sum to 1 over u at each such t and the emit posteriors to 1
    over t for each ``u < u_len``."""
    logits, labels, tl, ul = _rnnt_case(5, 10, 7, 9, seed=8)
    lp = torch.log_softmax(_t(logits), -1)
    blank = lp[..., 0].contiguous()
    emit = lp[:, :, :7].gather(3, _t(labels).long()[:, None, :, None]
                               .expand(5, 10, 7, 1)).squeeze(3)
    emit = torch.where(torch.arange(7) < _t(ul)[:, None, None], emit, NEG)
    emit = torch.nn.functional.pad(emit, (0, 1), value=NEG)
    args = (blank, emit, _t(tl), _t(ul))
    alphas, ll = rnnt_alpha_plain(*args)
    gb, ge, betas = rnnt_beta_grad_plain(*args[:2], alphas, *args[2:], ll,
                                         with_betas=True)
    t = torch.arange(10)[None, :, None]
    u = torch.arange(8)[None, None, :]
    dead = (t >= _t(tl)[:, None, None]) | (u > _t(ul)[:, None, None])
    assert (alphas[dead] == NEG).all() and (betas[dead] == NEG).all()
    assert not gb[dead].any() and not ge[dead].any()
    assert (alphas[~dead] > NEG / 2).all() and (betas[~dead] > NEG / 2).all()
    np.testing.assert_allclose(betas[:, 0, 0].numpy(), ll.numpy(), rtol=1e-5)
    for b in range(5):
        np.testing.assert_allclose(gb[b, :tl[b]].sum(1).numpy(), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(ge[b, :, :ul[b]].sum(0).numpy(), 1.0,
                                   rtol=1e-5)
    assert rnnt_lattice(*args).shape == (5,)
    with pytest.raises(ValueError):
        rnnt_alpha_plain(blank, emit[:, :, :-1], _t(tl), _t(ul))


# ---------------------------------------------------------------------------
# ConformerForRNNT
# ---------------------------------------------------------------------------

def _models(seed, **cfg):
    paddle_tpu.seed(seed)
    jm = JRNNT(j_conformer_tiny(**cfg))
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    arrays.update({n: np.asarray(b._value) for n, b in jm.named_buffers()})
    tm = ConformerForRNNT(conformer_tiny(**cfg), device="cpu")
    st = conformer_state_from_jax(arrays, tm)
    assert set(st) == set(tm.state_dict())
    missing, unexpected = tm.load_state_dict(st)
    assert not missing and not unexpected
    return jm, tm


def _batch(seed, vocab, B=2, T=40, feat=16, U=4):
    rng = np.random.RandomState(seed)
    feats = rng.rand(B, T, feat).astype(np.float32)
    labels = rng.randint(1, vocab, (B, U)).astype(np.int32)
    return feats, labels


def _tgrads(tm):
    out = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        owner = tm.get_submodule(n.rpartition(".")[0])
        out[n] = g.T if isinstance(owner, torch.nn.Linear) and \
            n.endswith("weight") else g
    return out


def test_conformer_rnnt_matches_reference_over_three_adamw_steps():
    """The logits, the loss and every parameter's gradient of the first
    step, then the loss sequence of 3 AdamW steps (as the reference's
    ``TestConformer.test_rnnt_head_trains``, with AdamW)."""
    jm, tm = _models(4)
    feats, labels = _batch(4, 32)
    jopt = JAdamW(learning_rate=3e-3, parameters=jm.parameters(),
                  weight_decay=0.01)
    topt = AdamW(learning_rate=3e-3, parameters=tm.parameters(),
                 weight_decay=0.01)
    tl, ul = np.array([10, 8], np.int32), np.array([4, 3], np.int32)
    jl, tls = [], []
    set_use_pallas(False)
    try:
        for step in range(3):
            jlog = jm(_j(feats), _j(labels))
            loss = JF.rnnt_loss(jlog, _j(labels), _j(tl), _j(ul))
            loss.backward()
            if step == 0:
                jlog0 = jlog.numpy()
                jg = {n: np.asarray(p.grad.numpy())
                      for n, p in jm.named_parameters()}
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss.numpy()))
    finally:
        set_use_pallas(None)
    for step in range(3):
        tlog = tm(_t(feats), _t(labels))
        loss = TF.rnnt_loss(tlog, _t(labels), _t(tl), _t(ul))
        loss.backward()
        if step == 0:
            assert tuple(tlog.shape) == (2, 10, 5, 32) == jlog0.shape
            np.testing.assert_allclose(tlog.detach().numpy(), jlog0,
                                       atol=1e-5, rtol=1e-5)
            tg = _tgrads(tm)
            assert set(tg) == set(jg)
            assert {n for n in tg if "predictor" in n or n == "embed.weight"}
            for n in jg:
                np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
        topt.step()
        topt.clear_grad()
        tls.append(loss.item())
    np.testing.assert_allclose(tls, jl, **TOL)
    assert tls[-1] < tls[0]


def test_converter_covers_every_rnnt_parameter_and_buffer():
    paddle_tpu.seed(6)
    jm = JRNNT(j_conformer_tiny(), predictor_hidden=24)
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    buffers = {n: np.asarray(b._value) for n, b in jm.named_buffers()}
    tm = ConformerForRNNT(conformer_tiny(), predictor_hidden=24,
                          device="cpu")
    st = conformer_state_from_jax({**arrays, **buffers}, tm)
    assert set(st) == set(tm.state_dict()) == set(arrays) | set(buffers)
    for name in ("embed.weight", "predictor.layers.0.cell.weight_ih",
                 "predictor.layers.0.cell.weight_hh"):
        np.testing.assert_array_equal(st[name].numpy(), arrays[name])
    # the converter keeps the reference's layouts (F4); loading transposes
    # the plain torch Linears' weights into torch's layout
    tm.load_state_dict(st)
    raw = torch.nn.Module.state_dict(tm)
    for name in ("enc_proj.weight", "joint.weight"):
        np.testing.assert_array_equal(st[name].numpy(), arrays[name])
        np.testing.assert_array_equal(raw[name].numpy(), arrays[name].T)
    assert st["predictor.layers.0.cell.weight_ih"].shape == (96, 24)
    assert st["enc_proj.weight"].shape == (32, 24)
    assert raw["enc_proj.weight"].shape == (24, 32)


def test_conformer_rnnt_init_is_the_references():
    m = ConformerForRNNT(conformer_tiny(), device="cpu", seed=0)
    assert 0.8 < m.embed.weight.std().item() < 1.2        # Normal(0, 1)
    bound = 1 / 32 ** 0.5
    for p in m.predictor.parameters():
        assert p.abs().max() <= bound
    assert not m.joint.bias.any()
    again = ConformerForRNNT(conformer_tiny(), device="cpu", seed=0)
    for (n, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n


def test_rnnt_slice_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch import amp\n"
        "from paddle_tpu_torch.models import ConformerForRNNT, "
        "conformer_tiny\n"
        "from paddle_tpu_torch.nn.functional import rnnt_loss\n"
        "cfg = conformer_tiny()\n"
        "cfg.dropout = 0.1\n"
        "m = ConformerForRNNT(cfg, device='cpu', seed=0)\n"
        "x, y = torch.rand(2, 32, 16), torch.tensor([[1, 2], [3, 3]])\n"
        "with amp.auto_cast(level='O1'):\n"
        "    logits = m(x, y)\n"
        "    loss = rnnt_loss(logits, y, torch.tensor([8, 7]),\n"
        "                     torch.tensor([2, 1]))\n"
        "loss.backward()\n"
        "print('ok', loss.dtype, round(loss.item(), 3))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok torch.float32")
