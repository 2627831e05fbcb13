"""The training slice of the PyTorch port (paddle_tpu_torch) against the JAX
package.

On the CPU every kernel wrapper runs its kernel's plain PyTorch version,
and the autograd Functions join the plain forwards to the plain backwards.
These tests hold them against the JAX package's own plain paths (its
Pallas entry points raise on this tree's jax, ROADMAP R1): the flash
kernel's ``_mirror_bwd`` / ``_bwd_mirror`` and ``jax.vjp`` of ``sdpa_ref``
(GQA), ``rmsnorm._mirror_bwd``, ``softmax_ce._mirror_fwd`` and its
``jax.grad``, ``nn.functional.cross_entropy``, ``AdamW.apply_gradients``,
and the whole ``LlamaPipelineTrainer`` from the same converted weights.
Inputs come from numpy seeds; f32 throughout. Kernel-level values use
atol = rtol = 1e-5 (XLA and torch sum in different orders); other
tolerances are stated where they are used.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.kernels import flash_attention as jflash
from paddle_tpu.kernels import rmsnorm as jrms
from paddle_tpu.kernels import softmax_ce as jce
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import sdpa_ref as j_sdpa_ref
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels.flash_attention import (
    delta_minus_glse, dropout_keep_plain, flash_attention_bwd_cuda,
    flash_attention_bwd_plain, flash_attention_cuda, flash_attention_fwd,
    flash_attention_plain)
from paddle_tpu_torch.kernels.rmsnorm import (
    rmsnorm, rmsnorm_bwd_cuda, rmsnorm_bwd_plain, rmsnorm_cuda,
    rmsnorm_plain, rmsnorm_residual)
from paddle_tpu_torch.kernels.softmax_ce import (
    softmax_ce, softmax_ce_bwd_plain, softmax_ce_cuda, softmax_ce_plain)
from paddle_tpu_torch.models import (LlamaPipelineTrainer, llama_tiny,
                                     trainer_state_from_jax)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _bhsd(a):
    """[B, S, H, D] -> the reference kernel's [B*H, S, D]."""
    B, S, H, D = a.shape
    return jnp.asarray(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(B * H, S, D)))


def _bshd(a, B, H):
    """[B*H, S, D] -> [B, S, H, D]."""
    a = np.asarray(a)
    return a.reshape(B, H, a.shape[1], a.shape[2]).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,sq,sk,with_glse", [
    (False, 37, 37, True), (True, 37, 37, True),    # ragged S
    (False, 16, 40, True),                          # Sq < Sk
    (True, 64, 64, False)])                         # no lse cotangent
def test_flash_bwd_plain_matches_mirror(causal, sq, sk, with_glse):
    rng = np.random.RandomState(0)
    B, H, D = 2, 3, 16
    q = rng.randn(B, sq, H, D).astype(np.float32)
    k = rng.randn(B, sk, H, D).astype(np.float32)
    v = rng.randn(B, sk, H, D).astype(np.float32)
    g = rng.randn(B, sq, H, D).astype(np.float32)
    glse = (0.3 * rng.randn(B, H, sq) if with_glse
            else np.zeros((B, H, sq))).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = map(_bhsd, (q, k, v, g))
    jout, jlse = jflash._mirror_fwd(jq, jk, jv, None, None, None, None,
                                    causal, scale, 0.0, 1)
    jdelta = jnp.sum(jg * jout, axis=-1, keepdims=True)
    if with_glse:
        ref = jflash._mirror_bwd(jq, jk, jv, jg,
                                 jnp.asarray(glse.reshape(B * H, sq, 1)),
                                 jlse, jdelta, None, None, None, None,
                                 causal, scale, 0.0, 1)
    else:
        ref = jflash._bwd_mirror(jq, jk, jv, jg, jlse, jdelta, causal, scale)
    ref = [_bshd(r, B, H) for r in ref]

    # the plain backward from the port's own forward
    out, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, H, sq), **TOL)
    dg = delta_minus_glse(out, _t(g), _t(glse))
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), lse, dg,
                                    causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, **TOL)

    # the same through the autograd Function, cotangents on out and lse
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    out, lse = flash_attention_fwd(*leaves, causal=causal)
    ((out * _t(g)).sum() + (lse * _t(glse)).sum()).backward()
    for leaf, b in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), b, **TOL)


@pytest.mark.parametrize("causal,sq,sk", [(True, 24, 24), (True, 10, 24),
                                          (False, 10, 24)])
def test_flash_grads_gqa_match_sdpa_ref_vjp(causal, sq, sk):
    """Public layout, 4 query heads on 2 KV heads, bottom-right causal:
    the Function's gradients against ``jax.vjp`` of the reference's
    ``sdpa_ref``, which repeats the KV heads and lets autodiff sum."""
    rng = np.random.RandomState(1)
    B, H, Hkv, D = 2, 4, 2, 16
    q = rng.randn(B, sq, H, D).astype(np.float32)
    k = rng.randn(B, sk, Hkv, D).astype(np.float32)
    v = rng.randn(B, sk, Hkv, D).astype(np.float32)
    g = rng.randn(B, sq, H, D).astype(np.float32)
    ref_out, vjp = jax.vjp(
        lambda a, b, c: j_sdpa_ref(a, b, c, is_causal=causal),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    out, _ = flash_attention_fwd(*leaves, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    (out * _t(g)).sum().backward()
    for leaf, b in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# flash attention dropout, backward
# ---------------------------------------------------------------------------

def _inject_port_mask(monkeypatch, B, H):
    """The reference's ``_mirror_dropmask`` replaced, in this test only, by
    the port's mask (``keep / (1 - p)``, ``[B*H, Sq, Sk]``)."""
    def dropmask(seed, BH, Sq, Sk, dropout_p):
        keep = dropout_keep_plain(int(np.asarray(seed)[0]), B, H, Sq, Sk,
                                  dropout_p).reshape(BH, Sq, Sk).numpy()
        return jnp.asarray(keep.astype(np.float32)) / (1.0 - dropout_p)
    monkeypatch.setattr(jflash, "_mirror_dropmask", dropmask)


@pytest.mark.parametrize("causal,sq,sk", [(False, 37, 37), (True, 37, 37),
                                          (False, 16, 40)])
def test_flash_dropout_bwd_plain_matches_mirror(monkeypatch, causal, sq, sk):
    rng = np.random.RandomState(7)
    B, H, D, p, seed = 2, 3, 16, 0.25, 4321
    q = rng.randn(B, sq, H, D).astype(np.float32)
    k = rng.randn(B, sk, H, D).astype(np.float32)
    v = rng.randn(B, sk, H, D).astype(np.float32)
    g = rng.randn(B, sq, H, D).astype(np.float32)
    glse = (0.3 * rng.randn(B, H, sq)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    _inject_port_mask(monkeypatch, B, H)
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv, jg = map(_bhsd, (q, k, v, g))
    jout, jlse = jflash._mirror_fwd(jq, jk, jv, None, None, None, jseed,
                                    causal, scale, p, H)
    jdelta = jnp.sum(jg * jout, axis=-1, keepdims=True)
    ref = jflash._mirror_bwd(jq, jk, jv, jg,
                             jnp.asarray(glse.reshape(B * H, sq, 1)), jlse,
                             jdelta, None, None, None, jseed, causal, scale,
                             p, H)
    ref = [_bshd(r, B, H) for r in ref]

    out, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                     dropout_p=p, seed=seed)
    dg = delta_minus_glse(out, _t(g), _t(glse))
    got = flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), lse, dg,
                                    causal, dropout_p=p, seed=seed)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, **TOL)

    # through the autograd Function: the backward regenerates the mask
    leaves = [_t(a, grad=True) for a in (q, k, v)]
    out, lse = flash_attention_fwd(*leaves, causal=causal, dropout_p=p,
                                   seed=seed)
    ((out * _t(g)).sum() + (lse * _t(glse)).sum()).backward()
    for leaf, b in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), b, **TOL)


def test_flash_dropout_gqa_keys_the_mask_by_query_head():
    """With GQA the mask of query head h is that of head h with the KV
    heads repeated: the plain versions with 2 KV heads for 4 query heads
    equal the dense-head run, dK/dV summed over each group."""
    rng = np.random.RandomState(8)
    B, S, H, Hkv, D, p, seed = 2, 19, 4, 2, 16, 0.3, 99
    q = _t(rng.randn(B, S, H, D).astype(np.float32), grad=True)
    k = _t(rng.randn(B, S, Hkv, D).astype(np.float32), grad=True)
    v = _t(rng.randn(B, S, Hkv, D).astype(np.float32), grad=True)
    g = _t(rng.randn(B, S, H, D).astype(np.float32))
    out, _ = flash_attention_fwd(q, k, v, dropout_p=p, seed=seed)
    (out * g).sum().backward()
    q2 = q.detach().clone().requires_grad_()
    k2 = k.detach().repeat_interleave(2, dim=2).requires_grad_()
    v2 = v.detach().repeat_interleave(2, dim=2).requires_grad_()
    out2, _ = flash_attention_fwd(q2, k2, v2, dropout_p=p, seed=seed)
    (out2 * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out2.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(q.grad.numpy(), q2.grad.numpy(), **TOL)
    for a, b in ((k, k2), (v, v2)):
        np.testing.assert_allclose(
            a.grad.numpy(), b.grad.reshape(B, S, Hkv, 2, D).sum(3).numpy(),
            **TOL)


def test_flash_dropout_forward_and_backward_apply_one_mask():
    """Probes read each plain version's applied mask: with q = k = 0 every
    probability is 1 / S, so out = z / (S (1 - p)) for v = I; dQ with
    k = v = I and dO = 1 is scale z / (S (1 - p)); dV with dO = I is the
    transposed mask. All three equal the keep bits."""
    B, H, S, p, seed = 2, 3, 16, 0.3, 5
    D = S
    scale = 1.0 / np.sqrt(D)
    eye = torch.eye(S)[None, :, None, :].expand(B, S, H, D).contiguous()
    zeros = torch.zeros(B, S, H, D)
    keep = dropout_keep_plain(seed, B, H, S, S, p).float()     # [B,H,i,j]
    out, lse = flash_attention_plain(zeros, zeros, eye, dropout_p=p,
                                     seed=seed)
    z = (out * S * (1 - p)).round().permute(0, 2, 1, 3)
    assert torch.equal(z, keep)
    dg = torch.zeros(B, H, S)
    dq, _, _ = flash_attention_bwd_plain(zeros, eye, eye, torch.ones_like(eye),
                                         lse, dg, dropout_p=p, seed=seed)
    zq = (dq / (scale / S / (1 - p))).round().permute(0, 2, 1, 3)
    assert torch.equal(zq, keep)
    _, _, dv = flash_attention_bwd_plain(zeros, zeros, eye, eye, lse, dg,
                                         dropout_p=p, seed=seed)
    zv = (dv * S * (1 - p)).round().permute(0, 2, 3, 1)
    assert torch.equal(zv, keep)


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_bwd_plain_matches_mirror(residual):
    rng = np.random.RandomState(2)
    x = rng.randn(13, 24).astype(np.float32)
    r = rng.randn(13, 24).astype(np.float32)
    w = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    g = rng.randn(13, 24).astype(np.float32)
    jx, jr, jw, jg = map(jnp.asarray, (x, r, w, g))
    _, jrstd = jrms._mirror(jx, jr, jw, 1e-5, residual)
    jdx, jdw = jrms._mirror_bwd(jx, jr, jw, jrstd, jg, residual)

    res = _t(r) if residual else None
    _, _, rstd = rmsnorm_plain(_t(x), _t(w), 1e-5, res)
    dx, dw = rmsnorm_bwd_plain(_t(x), _t(w), rstd, _t(g), res)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)

    # through the autograd Function: dresid = dx
    tx, tr, tw = _t(x, True), _t(r, True), _t(w, True)
    out = rmsnorm_residual(tx, tr, tw, 1e-5)[0] if residual else rmsnorm(
        tx, tw, 1e-5)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
    if residual:
        np.testing.assert_array_equal(tr.grad.numpy(), tx.grad.numpy())


def test_rmsnorm_residual_sum_output_carries_its_gradient():
    """``h = x + residual`` is an output too; its gradient reaches both
    addends on top of the norm's."""
    rng = np.random.RandomState(3)
    x, r = rng.randn(5, 16).astype(np.float32), rng.randn(5, 16).astype(np.float32)
    w = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    g1, g2 = rng.randn(5, 16).astype(np.float32), rng.randn(5, 16).astype(np.float32)

    def ref(a, b, c):
        s = a + b
        out = s * jax.lax.rsqrt(jnp.mean(s * s, -1, keepdims=True) + 1e-5) * c
        return jnp.sum(out * g1) + jnp.sum(s * g2)

    want = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (x, r, w)))
    tx, tr, tw = _t(x, True), _t(r, True), _t(w, True)
    out, h = rmsnorm_residual(tx, tr, tw, 1e-5)
    ((out * _t(g1)).sum() + (h * _t(g2)).sum()).backward()
    for leaf, b in zip((tx, tr, tw), want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# softmax cross-entropy and cross_entropy
# ---------------------------------------------------------------------------

def test_softmax_ce_plain_matches_mirror_and_its_grad():
    rng = np.random.RandomState(4)
    N, V = 11, 37                                       # an odd vocab
    x = (3 * rng.randn(N, V)).astype(np.float32)
    lab = rng.randint(0, V, N).astype(np.int64)
    gw = rng.rand(N).astype(np.float32)
    jloss, jlse = jce._mirror_fwd(jnp.asarray(x), jnp.asarray(lab))
    jgrad = jax.grad(lambda a: jnp.sum(
        jnp.asarray(gw) * jce._mirror_fwd(a, jnp.asarray(lab))[0]))(
            jnp.asarray(x))
    loss, lse = softmax_ce_plain(_t(x), _t(lab))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], **TOL)
    dx = softmax_ce_bwd_plain(_t(x), _t(lab), lse, _t(gw))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jgrad), **TOL)
    tx = _t(x, True)
    (softmax_ce(tx, _t(lab).int()) * _t(gw)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **TOL)


def _jax_ce(x, lab, weight=None, **kw):
    xt = paddle_tpu.to_tensor(x, stop_gradient=False)
    if weight is not None:
        kw["weight"] = paddle_tpu.to_tensor(weight)
    loss = JF.cross_entropy(xt, paddle_tpu.to_tensor(lab), **kw)
    loss.sum().backward()
    return loss.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("case", [
    "hard_mean", "hard_sum", "hard_none", "hard_trailing_axis",
    "soft", "soft_smoothing", "hard_smoothing", "weight_mean",
    "weight_none"])
def test_cross_entropy_matches_reference(case):
    rng = np.random.RandomState(5)
    V = 13
    x = (2 * rng.randn(3, 5, V)).astype(np.float32)
    lab = rng.randint(0, V, (3, 5)).astype(np.int64)
    lab[0, :2] = -100                                   # ignored rows
    kw = {}
    if case.startswith("hard") or case.startswith("weight"):
        kw["reduction"] = {"hard_sum": "sum", "hard_none": "none",
                           "weight_none": "none"}.get(case, "mean")
    if case == "hard_trailing_axis":
        lab = lab[..., None]
    if case.startswith("soft"):
        lab = rng.rand(3, 5, V).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
        kw["soft_label"] = True
    if case.endswith("smoothing"):
        kw["label_smoothing"] = 0.1
    if case.startswith("weight"):
        kw["weight"] = rng.rand(V).astype(np.float32)
    want, want_grad = _jax_ce(x, lab, **kw)
    if "weight" in kw:
        kw["weight"] = _t(kw["weight"])
    tx = _t(x, True)
    loss = cross_entropy(tx, _t(lab), **kw)
    np.testing.assert_allclose(loss.detach().numpy(), want, **TOL)
    loss.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_grad, **TOL)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("AdamW", {}),
                                     ("AdamW", {"weight_decay": 0.1}),
                                     ("Adam", {}),
                                     ("Adam", {"weight_decay": 0.01})])
def test_optimizer_three_updates_match_apply_gradients(name, kw):
    """Three updates of the port's optimizer against the reference's pure
    ``apply_gradients`` on the same params and grads: the same f32
    arithmetic in the same order, so atol 1e-7 (a few ulps at |p| ~ 1)."""
    rng = np.random.RandomState(6)
    shapes = {"a": (5, 7), "b": (11,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = {"AdamW": JAdamW, "Adam": JAdam}[name](learning_rate=1e-3, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init_state_tree(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = {"AdamW": AdamW, "Adam": Adam}[name](
        learning_rate=1e-3, parameters=list(tp.values()), **kw)
    for gr in grads:
        jp, jst = jopt.apply_gradients(jp, {k: jnp.asarray(g)
                                            for k, g in gr.items()}, jst)
        for k, p in tp.items():
            p.grad = _t(gr[k])
        topt.step()
        topt.clear_grad()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=0)
            st = topt.state_for(p)
            for s in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
                np.testing.assert_allclose(st[s].numpy(),
                                           np.asarray(jst[k][s]),
                                           atol=1e-7, rtol=1e-6)
            assert p.grad is None


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           seq=32)
LR = 1e-3


def test_trainer_three_steps_match_reference():
    """The reference's ``LlamaPipelineTrainer`` (dp = 1, n_micro = 1,
    ZeRO stage 1, AdamW lr 1e-3) on ``llama_tiny`` with GQA against the
    port's trainer started from its converted parameters: 3 steps on
    seeded batches. Losses within the tolerance ``test_zero_offload.py``
    holds the reference's own two update paths to (rtol 2e-4, atol 2e-5).
    Weights after 3 steps within 6 * lr: each of Adam's first updates
    moves a weight by about lr * sign(g), so a gradient near zero whose
    last bits differ can move it by up to 2 * lr the other way per step;
    all but one in a thousand weights must agree within lr / 1000."""
    from paddle_tpu.distributed.mesh import (build_mesh,
                                             set_hybrid_communicate_group)
    from paddle_tpu.models import llama_tiny as j_llama_tiny
    from paddle_tpu.models.llama_pipeline import (
        LlamaPipelineTrainer as JTrainer)

    rng = np.random.RandomState(7)
    xs = [rng.randint(0, 128, (2, 16)).astype(np.int64) for _ in range(3)]
    ys = [rng.randint(0, 128, (2, 16)).astype(np.int64) for _ in range(3)]
    paddle_tpu.seed(0)
    try:
        jtr = JTrainer(j_llama_tiny(**CFG), build_mesh(degrees={"dp": 1}),
                       JAdamW(learning_rate=LR), n_micro=1, zero_stage=1)
        n_params = jtr.num_params()            # builds the reference state
        init = {k: np.asarray(v) for k, v in jtr._state[0].items()}
        want = [float(np.asarray(jax.block_until_ready(jtr.step(x, y))))
                for x, y in zip(xs, ys)]
        final = {k: np.asarray(v) for k, v in jtr._state[0].items()}
        flops = (jtr.flops_per_token(16), jtr.matmul_flops_per_token(16))
    finally:
        set_hybrid_communicate_group(None)

    tr = LlamaPipelineTrainer(llama_tiny(**CFG), AdamW(learning_rate=LR),
                              device="cpu")
    missing, unexpected = tr.model.load_state_dict(
        trainer_state_from_jax(init))
    assert not missing and not unexpected
    assert tr.num_params() == n_params
    assert (tr.flops_per_token(16), tr.matmul_flops_per_token(16)) == flops
    before = K.launch_counts()
    got = [tr.step(x, y).item() for x, y in zip(xs, ys)]
    assert K.launch_counts() == before      # the CPU never counts a launch
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    final = trainer_state_from_jax(final)
    diffs = []
    for n, p in tr.model.named_parameters():
        d = np.abs(p.detach().numpy() - final[n].numpy())
        assert d.max() <= 6 * LR, n
        diffs.append(d.ravel())
    assert np.quantile(np.concatenate(diffs), 0.999) <= LR / 1000


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_same_loss_and_grads(remat):
    """Recomputation replays the same ops: the loss and every gradient
    equal those without remat (atol 1e-6 for summation-order noise)."""
    x = torch.from_numpy(np.random.RandomState(8).randint(0, 128, (2, 16)))
    out = {}
    for policy in ("off", remat):
        tr = LlamaPipelineTrainer(llama_tiny(**CFG), AdamW(), remat=policy,
                                  device="cpu", seed=3)
        loss = tr.loss_and_grads(x, x.roll(-1, 1))
        out[policy] = (loss, [p.grad for p in tr.model.parameters()])
    torch.testing.assert_close(out[remat][0], out["off"][0], atol=1e-6,
                               rtol=0)
    for a, b in zip(out[remat][1], out["off"][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_micro_batches_accumulate_the_full_batch_gradient():
    x = torch.from_numpy(np.random.RandomState(9).randint(0, 128, (4, 16)))
    out = []
    for n_micro in (1, 2):
        tr = LlamaPipelineTrainer(llama_tiny(**CFG), AdamW(), n_micro=n_micro,
                                  device="cpu", seed=4)
        out.append((tr.loss_and_grads(x, x.roll(1, 1)),
                    [p.grad for p in tr.model.parameters()]))
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-6, rtol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_trainer_state_from_jax_unstacks_and_transposes():
    rng = np.random.RandomState(10)
    params = {"blocks.self_attn.qkv_proj.weight": rng.randn(2, 1, 4, 6),
              "blocks.input_layernorm.weight": rng.randn(2, 1, 4),
              "embed.weight": rng.randn(9, 4), "norm.weight": rng.randn(4),
              "head.weight": rng.randn(4, 9)}
    st = trainer_state_from_jax(params)
    np.testing.assert_array_equal(st["layers.1.self_attn.qkv_proj.weight"],
                                  params["blocks.self_attn.qkv_proj.weight"][1, 0].T)
    np.testing.assert_array_equal(st["layers.0.input_layernorm.weight"],
                                  params["blocks.input_layernorm.weight"][0, 0])
    np.testing.assert_array_equal(st["embed_tokens.weight"], params["embed.weight"])
    np.testing.assert_array_equal(st["lm_head.weight"], params["head.weight"].T)
    with pytest.raises(KeyError):
        trainer_state_from_jax({"blocks_extra.w": np.zeros(1)})


def test_trainer_rejects_unknown_options():
    with pytest.raises(ValueError):
        LlamaPipelineTrainer(llama_tiny(**CFG), AdamW(), remat="some",
                             device="cpu")
    with pytest.raises(ValueError):
        LlamaPipelineTrainer(llama_tiny(**CFG), AdamW(), n_micro=0,
                             device="cpu")


# ---------------------------------------------------------------------------
# the slice-1 fault: no raw kernel output cut from the autograd graph
# ---------------------------------------------------------------------------

def test_raw_kernel_wrappers_refuse_inputs_that_require_grad():
    """The raw ``*_cuda`` wrappers return buffers a ctypes launch filled; fed
    a tensor that requires grad with grad mode on, they raise before any
    device work (so this runs on the CPU too) instead of returning an
    output with no ``grad_fn``. Under ``no_grad`` they get past that check."""
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.ones(64)
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    lse = torch.zeros(1, 2, 8)
    lab = torch.zeros(4, dtype=torch.int64)
    for call in (lambda: rmsnorm_cuda(x, w, 1e-5),
                 lambda: rmsnorm_bwd_cuda(x, w, lse[0, 0, :4], x),
                 lambda: softmax_ce_cuda(x, lab),
                 lambda: flash_attention_cuda(q, q, q),
                 lambda: flash_attention_bwd_cuda(q, q, q, q, lse, lse)):
        with pytest.raises(RuntimeError, match="no autograd"):
            call()


def test_functionals_keep_the_graph_on_the_cpu():
    x = torch.randn(2, 6, 2, 64, requires_grad=True)
    out, lse = flash_attention_fwd(x, x, x, causal=True)
    assert out.grad_fn is not None and lse.grad_fn is not None
    assert rmsnorm(x, torch.ones(64)).grad_fn is not None
    assert softmax_ce(x.reshape(-1, 64), torch.zeros(24, dtype=torch.long)
                      ).grad_fn is not None
