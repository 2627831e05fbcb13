"""The ERNIE slice of the PyTorch port (paddle_tpu_torch) against the JAX
package, on the CPU.

One tiny reference model supplies the weights; ``ernie_state_from_jax``
carries them into the port (never a re-initialisation). With dropout 0,
logits, loss and every parameter's gradient must match the reference's
eager (dygraph) model at atol = rtol = 1e-4 (f32; XLA and torch sum in
different orders), and a 3-step AdamW + LinearWarmup + ClipGradByGlobalNorm
loop must give the reference's losses. ``amp.auto_cast(O1)`` logits agree
with the reference's O1 within 2e-2 relative L2 (both round the matmul
operands to bf16, at the same points, but XLA and torch round their bf16
products differently). Schedulers and clips are pure arithmetic and match
at 1e-12 / 1e-6.

Hidden dropout (``nn.functional.dropout``) draws from torch generators and
cannot reproduce JAX's bits: it is tested for its statistics only, the
keep share within a binomial bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu import amp as jamp
from paddle_tpu.models import ErnieForMaskedLM as JErnieMLM
from paddle_tpu.models import ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models import ernie_tiny as j_ernie_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import (ErnieForMaskedLM, ErnieForSequenceClassification,
                                     ernie_state_from_jax, ernie_tiny)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(vocab=97, hidden=64, layers=2, heads=4, inter=128, seq=32)


def _export(jm, seed):
    """The reference's parameters as numpy, LayerNorm weights and biases
    made random so every tensor's conversion is exercised."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        a = np.asarray(p._value)
        if "norm" in name:
            a = (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            p._value = jnp.asarray(a)
        params[name] = a
    return params


def _pair(jcls, tcls, seed, **kw):
    paddle_tpu.seed(seed)
    jm = jcls(j_ernie_tiny(**CFG), **kw)
    params = _export(jm, seed)
    tm = tcls(ernie_tiny(**CFG), device="cpu", **kw)
    missing, unexpected = tm.load_state_dict(ernie_state_from_jax(params, tm))
    assert not missing and not unexpected
    return jm, tm


def _ids(seed, b=2, t=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab"], (b, t)).astype(np.int64)
    labels = np.where(rng.rand(b, t) < 0.3, ids, -100).astype(np.int64)
    labels[0, 0] = ids[0, 0]                     # at least one label
    return ids, labels


def _jgrads(jm):
    return {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
            if p.grad is not None}


def _tgrads(tm):
    """The port's gradients in the reference's layout."""
    out = {}
    for n, p in tm.named_parameters():
        if p.grad is None:
            continue
        owner = tm.get_submodule(n.rpartition(".")[0])
        g = p.grad.numpy()
        out[n] = g.T if isinstance(owner, torch.nn.Linear) and \
            n.endswith("weight") else g
    return out


def test_converter_transposes_exactly_the_linear_weights():
    jm, tm = _pair(JErnieMLM, ErnieForMaskedLM, 0)
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    st = ernie_state_from_jax(params, tm)
    assert set(st) == set(tm.state_dict())
    linears = {n for n, m in tm.named_modules()
               if isinstance(m, torch.nn.Linear)}
    for name, a in params.items():
        owner = name.rpartition(".")[0]
        want = a.T if owner in linears and name.endswith("weight") else a
        np.testing.assert_array_equal(st[name].numpy(), want)
    assert "encoder.layers.1.self_attn.q_proj" in {
        o[len("ernie."):] for o in linears}
    with pytest.raises(KeyError):
        ernie_state_from_jax({"nope.weight": params["decoder.bias"]}, tm)


def test_masked_lm_logits_loss_and_grads_match_reference():
    jm, tm = _pair(JErnieMLM, ErnieForMaskedLM, 1)
    ids, labels = _ids(1)
    V = CFG["vocab"]
    jlogits = jm(paddle_tpu.to_tensor(ids))
    jloss = JF.cross_entropy(jlogits.reshape([-1, V]),
                             paddle_tpu.to_tensor(labels.reshape(-1)))
    jloss.backward()
    logits = tm(torch.from_numpy(ids))
    loss = TF.cross_entropy(logits.reshape(-1, V),
                            torch.from_numpy(labels.reshape(-1)))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **TOL)
    jg, tg = _jgrads(jm), _tgrads(tm)
    # the pooler feeds no loss: neither package gives it a gradient
    assert set(tg) == set(jg) and "ernie.pooler.weight" not in tg
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)


def test_classification_with_padding_mask_matches_reference():
    jm, tm = _pair(JErnieCls, ErnieForSequenceClassification, 2,
                   num_classes=3)
    ids, _ = _ids(2, b=3, t=10)
    mask = np.ones((3, 10), np.float32)
    mask[0, 7:] = 0
    mask[2, 4:] = 0
    y = np.array([0, 2, 1], np.int64)
    jlogits = jm(paddle_tpu.to_tensor(ids),
                 attention_mask=paddle_tpu.to_tensor(mask))
    jloss = JF.cross_entropy(jlogits, paddle_tpu.to_tensor(y))
    jloss.backward()
    logits = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    loss = TF.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **TOL)
    jg, tg = _jgrads(jm), _tgrads(tm)
    assert set(tg) == set(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)


def test_three_step_loop_matches_reference():
    """model(x), loss.backward(), opt.step() as in tests/test_ernie.py, with
    AdamW over LinearWarmup and ClipGradByGlobalNorm."""
    jm, tm = _pair(JErnieMLM, ErnieForMaskedLM, 3)
    ids, labels = _ids(3)
    V = CFG["vocab"]
    jsched = jlr.LinearWarmup(2e-3, warmup_steps=2, start_lr=1e-4,
                              end_lr=2e-3)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters(),
                  weight_decay=0.01, grad_clip=jnn.ClipGradByGlobalNorm(0.5))
    tsched = tlr.LinearWarmup(2e-3, warmup_steps=2, start_lr=1e-4,
                              end_lr=2e-3)
    topt = AdamW(learning_rate=tsched, parameters=tm.parameters(),
                 weight_decay=0.01, grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    jx, jy = paddle_tpu.to_tensor(ids), paddle_tpu.to_tensor(labels.reshape(-1))
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels.reshape(-1))
    jl, tl = [], []
    for _ in range(3):
        loss = JF.cross_entropy(jm(jx).reshape([-1, V]), jy)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        jl.append(float(loss.numpy()))
        loss = TF.cross_entropy(tm(tx).reshape(-1, V), ty)
        loss.backward()
        topt.step()
        topt.clear_grad()
        tsched.step()
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


def test_auto_cast_o1_logits_match_reference():
    jm, tm = _pair(JErnieMLM, ErnieForMaskedLM, 4)
    ids, _ = _ids(4)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jlogits = np.asarray(jm(paddle_tpu.to_tensor(ids)).numpy(),
                             np.float32)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        logits = tm(torch.from_numpy(ids))
        # O1: the decoder (white list) runs in bf16, layer_norm (black
        # list) took f32 inputs
        h = tm.layer_norm(TF.gelu(tm.transform(tm.ernie(
            torch.from_numpy(ids))[0])))
    assert logits.dtype == torch.bfloat16 and h.dtype == torch.float32
    got = logits.float().detach().numpy()
    rel = np.linalg.norm(got - jlogits) / np.linalg.norm(jlogits)
    assert rel < 2e-2, rel
    with torch.no_grad():
        f32 = tm(torch.from_numpy(ids)).numpy()
    assert np.linalg.norm(got - f32) / np.linalg.norm(f32) > 1e-4  # it cast


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_reference(normalize_before):
    from paddle_tpu.nn import TransformerEncoderLayer as JLayer
    from paddle_tpu_torch.nn import TransformerEncoderLayer as TLayer

    paddle_tpu.seed(5)
    jl = JLayer(32, 4, 64, dropout=0.0, activation="gelu",
                normalize_before=normalize_before)
    params = _export(jl, 5)
    tl = TLayer(32, 4, 64, dropout=0.0, activation="gelu",
                normalize_before=normalize_before, device="cpu")
    tl.load_state_dict(ernie_state_from_jax(params, tl))
    x = np.random.RandomState(5).randn(2, 9, 32).astype(np.float32)
    bias = np.zeros((2, 1, 1, 9), np.float32)
    bias[1, ..., 6:] = -1e9
    for m in (None, bias):
        want = jl(paddle_tpu.to_tensor(x),
                  None if m is None else paddle_tpu.to_tensor(m)).numpy()
        got = tl(torch.from_numpy(x),
                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# schedulers and clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda L: L.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1),
    lambda L: L.LinearWarmup(L.CosineAnnealingDecay(0.2, T_max=5),
                             warmup_steps=3, start_lr=0.01, end_lr=0.2),
    lambda L: L.LinearWarmup(L.PolynomialDecay(0.2, decay_steps=4),
                             warmup_steps=2, start_lr=0.0, end_lr=0.2),
    lambda L: L.PolynomialDecay(0.5, decay_steps=5, end_lr=0.01, power=2.0),
    lambda L: L.PolynomialDecay(0.5, decay_steps=3, cycle=True),
    lambda L: L.CosineAnnealingDecay(1.0, T_max=7, eta_min=0.1),
])
def test_scheduler_sequences_match_reference(make):
    js, ts = make(jlr), make(tlr)
    seq_j, seq_t = [], []
    for _ in range(12):
        seq_j.append(js())
        seq_t.append(ts())
        js.step()
        ts.step()
    np.testing.assert_allclose(seq_t, seq_j, rtol=1e-12, atol=1e-12)


def test_optimizer_reads_its_scheduler():
    sched = tlr.LinearWarmup(0.1, warmup_steps=2, start_lr=0.0, end_lr=0.1)
    opt = AdamW(learning_rate=sched, parameters=[torch.nn.Parameter(
        torch.ones(2))])
    got = []
    for _ in range(3):
        got.append(opt.get_lr())
        sched.step()
    assert got == [0.0, 0.05, 0.1]
    with pytest.raises(RuntimeError):
        opt.set_lr(1.0)


@pytest.mark.parametrize("make", [
    lambda N: N.ClipGradByGlobalNorm(1.0),
    lambda N: N.ClipGradByGlobalNorm(100.0),          # no clipping
    lambda N: N.ClipGradByNorm(0.7),
    lambda N: N.ClipGradByValue(0.3),
    lambda N: N.ClipGradByValue(0.5, min=-0.1),
])
def test_clips_match_reference(make):
    rng = np.random.RandomState(6)
    grads = [rng.randn(3, 4).astype(np.float32),
             rng.randn(5).astype(np.float32), None]
    jout = make(jnn)([(i, None if g is None else paddle_tpu.to_tensor(g))
                      for i, g in enumerate(grads)])
    tout = make(tnn)([(i, None if g is None else torch.from_numpy(g))
                      for i, g in enumerate(grads)])
    for (ji, jg), (ti, tg) in zip(jout, tout):
        assert ji == ti
        if jg is None:
            assert tg is None
        else:
            np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_clip_then_decay_then_update_order():
    """Clip before decay: decay stays out of the clipped norm (reference
    ``Optimizer.step``)."""
    from paddle_tpu_torch.optimizer import Adam

    p = torch.nn.Parameter(torch.full((4,), 2.0))
    p.grad = torch.full((4,), 3.0)
    opt = Adam(learning_rate=0.1, parameters=[p], weight_decay=0.5,
               grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    seen = []
    opt.update = lambda param, g, state, lr: seen.append(g.clone())
    opt.step()
    # clipped to norm 1 (0.5 each), then L2 decay 0.5 * 2.0 added
    np.testing.assert_allclose(seen[0].numpy(), np.full(4, 1.5), rtol=1e-6)


# ---------------------------------------------------------------------------
# dropout (hidden): statistics only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_share_and_scaling(p):
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(7)
    y = TF.dropout(x, p=p, training=True, generator=g)
    keep = (y != 0).float().mean().item()
    n = x.numel()
    assert abs(keep - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    down = TF.dropout(x, p=p, training=True, mode="downscale_in_infer",
                      generator=g)
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_allclose(
        TF.dropout(x, p=p, training=False, mode="downscale_in_infer").numpy(),
        1 - p)
    assert TF.dropout(x, p=p, training=False) is x
    # axis: whole rows share one draw
    rows = TF.dropout(x, p=p, axis=0, generator=g)
    assert ((rows == 0).all(1) | (rows != 0).all(1)).all()


def test_dropout_layer_follows_train_and_eval():
    layer = tnn.Dropout(0.5)
    x = torch.ones(64, 64)
    assert (layer(x) == 0).any()
    layer.eval()
    assert torch.equal(layer(x), x)


def test_seed_makes_dropout_reproducible():
    from paddle_tpu_torch import framework

    x = torch.ones(1000)
    framework.seed(11)
    a = TF.dropout(x, p=0.3)
    s1 = framework.next_seed()
    framework.seed(11)
    assert torch.equal(TF.dropout(x, p=0.3), a)
    assert framework.next_seed() == s1


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_runs_with_jax_unimportable():
    """Every module of the port and chip_smoke.py import, and the ERNIE
    slice trains a step, in a process where importing jax or paddle_tpu
    raises."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import torch\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from paddle_tpu_torch import amp\n"
        "from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_tiny\n"
        "from paddle_tpu_torch.nn.functional import cross_entropy\n"
        "cfg = ernie_tiny(vocab=50, hidden=32, layers=1, heads=2, inter=64)\n"
        "cfg.attention_probs_dropout_prob = 0.1\n"
        "m = ErnieForMaskedLM(cfg, device='cpu', seed=0)\n"
        "x = torch.randint(0, 50, (2, 8))\n"
        "with amp.auto_cast(level='O1'):\n"
        "    loss = cross_entropy(m(x).reshape(-1, 50), x.reshape(-1))\n"
        "loss.backward()\n"
        "print('ok', round(loss.item(), 3))\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_ernie_refuses_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForMaskedLM(ernie_tiny(**CFG))
