"""Kernel modules of the PyTorch port (paddle_tpu_torch.kernels) against the
JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that version against the JAX package's own plain paths (the Pallas
entry points raise on this tree's jax, ROADMAP R1): ``paged_attention_ref``,
the flash kernel's ``_mirror_fwd`` (with the port's dropout mask injected
for the dropout cases), ``sdpa_ref``, the ``F.rms_norm`` composition,
``rmsnorm._mirror`` and ``layer_norm_pallas`` (whose kernel runs in Pallas'
interpret mode on the CPU). Inputs come from a numpy seed and go to both
packages; f32 atol = rtol = 1e-5 (the summation order differs between XLA
and torch); bf16 outputs to one bf16 step (2^-7 relative) of the output's
scale.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.kernels import flash_attention as jflash
from paddle_tpu.kernels import rmsnorm as jrms
from paddle_tpu.kernels.layernorm import layer_norm_pallas
from paddle_tpu.kernels.paged_attention import paged_attention_ref
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import sdpa_ref as j_sdpa_ref

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.flash_attention import (
    dropout_bits_plain, dropout_keep_plain, flash_attention_fwd,
    flash_attention_plain)
from paddle_tpu_torch.kernels.layernorm import layer_norm_plain, layernorm
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.kernels.rmsnorm import (
    rmsnorm, rmsnorm_plain, rmsnorm_residual)
from paddle_tpu_torch.nn.functional import (
    layer_norm, rms_norm, scaled_dot_product_attention, sdpa_ref)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _paged_case(seed, Hq, Hkv, S=4, D=16, bs=8, N=12, M=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, Hq, D).astype(np.float32)
    pool = rng.randn(N, 2, Hkv, bs, D).astype(np.float32)
    bt = rng.randint(0, N, (S, M)).astype(np.int32)
    ctx = np.array([1, 13, M * bs, 9][:S], np.int32)  # 1, non-multiples, full
    return q, pool, bt, ctx


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_paged_attention_plain_matches_reference(Hq, Hkv):
    q, pool, bt, ctx = _paged_case(0, Hq, Hkv)
    ref = np.asarray(paged_attention_ref(jnp.asarray(q), jnp.asarray(pool),
                                         jnp.asarray(bt), jnp.asarray(ctx)))
    before = K.launch_counts()
    out = paged_attention(_t(q), _t(pool), _t(bt), _t(ctx))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert K.launch_counts() == before      # the CPU never counts a launch


def test_paged_attention_scale_and_single_token():
    q, pool, bt, _ = _paged_case(1, 4, 2)
    ctx = np.ones(4, np.int32)
    out = paged_attention_plain(_t(q), _t(pool), _t(bt), _t(ctx),
                                sm_scale=0.3).numpy()
    # softmax over one position is that position's V
    first = pool[bt[:, 0], 1, :, 0]                     # [S, Hkv, D]
    np.testing.assert_allclose(out, np.repeat(first, 2, axis=1), **TOL)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [37, 64])
def test_flash_forward_plain_matches_mirror(causal, S):
    rng = np.random.RandomState(S)
    B, H, D = 2, 4, 16
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(D)

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    ref_out, ref_lse = jflash._mirror_fwd(
        bhsd(q), bhsd(k), bhsd(v), None, None, None, None, causal, scale,
        0.0, H)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_out).reshape(B, H, S, D)
        .transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(B, H, S), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_gqa_matches_reference_sdpa_ref(causal):
    rng = np.random.RandomState(3)
    q = rng.randn(2, 11, 4, 16).astype(np.float32)
    k = rng.randn(2, 11, 2, 16).astype(np.float32)
    v = rng.randn(2, 11, 2, 16).astype(np.float32)
    ref = np.asarray(j_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), is_causal=causal))
    out = scaled_dot_product_attention(_t(q), _t(k), _t(v), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    plain = sdpa_ref(_t(q), _t(k), _t(v), is_causal=causal)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)


def _mirror_mask(B, H):
    """A stand-in for the reference's ``_mirror_dropmask`` that returns the
    port's mask, scaled as the mirror scales its own (``keep / (1 - p)``),
    in the mirror's ``[B*H, Sq, Sk]`` layout."""
    def dropmask(seed, BH, Sq, Sk, dropout_p):
        keep = dropout_keep_plain(int(np.asarray(seed)[0]), B, H, Sq, Sk,
                                  dropout_p).reshape(BH, Sq, Sk).numpy()
        return jnp.asarray(keep.astype(np.float32)) / (1.0 - dropout_p)
    return dropmask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [37, 64])
def test_flash_dropout_forward_plain_matches_mirror(monkeypatch, causal, S):
    rng = np.random.RandomState(S + 1)
    B, H, D, p, seed = 2, 3, 16, 0.2, 1234
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))

    def bhsd(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    monkeypatch.setattr(jflash, "_mirror_dropmask", _mirror_mask(B, H))
    ref_out, ref_lse = jflash._mirror_fwd(
        bhsd(q), bhsd(k), bhsd(v), None, None, None,
        jnp.asarray([seed], jnp.int32), causal, 1.0 / np.sqrt(D), p, H)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                   dropout_p=p, seed=seed)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_out).reshape(B, H, S, D)
        .transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(B, H, S), **TOL)
    dense, _ = flash_attention_plain(_t(q), _t(k), _t(v), causal)
    assert not np.allclose(out.numpy(), dense.numpy())      # it dropped


def test_dropout_bits_keep_share_and_independence():
    """Keep share within 5 sigma of 1 - p; the mask differs between heads,
    rows and seeds, and does not repeat along a row."""
    B, H, S, p = 2, 4, 256, 0.1
    keep = dropout_keep_plain(7, B, H, S, S, p)
    n = keep.numel()
    share = keep.float().mean().item()
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    flat = keep.reshape(B * H, S, S)
    assert not torch.equal(flat[0], flat[1])
    assert not torch.equal(flat[0, 0], flat[0, 1])
    assert not torch.equal(keep, dropout_keep_plain(8, B, H, S, S, p))
    bits = dropout_bits_plain(7, B * H, S, S)
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    # each bit of the 32 is set about half the time
    for b in (0, 15, 31):
        assert abs(((bits >> b) & 1).float().mean().item() - 0.5) < 0.01


def test_sdpa_routes_masks_as_the_reference():
    """No mask: the flash path; a float bias: ``sdpa_ref``, the reference's
    einsum composition with the bias added; a bool mask: the flash path's
    plain version on CPU tensors, equal to ``sdpa_ref`` on rows that keep a
    key; ``training=False`` turns dropout off."""
    rng = np.random.RandomState(9)
    q = rng.randn(2, 6, 2, 8).astype(np.float32)
    k = rng.randn(2, 6, 2, 8).astype(np.float32)
    v = rng.randn(2, 6, 2, 8).astype(np.float32)
    bias = np.where(rng.rand(2, 1, 1, 6) > 0.3, 0.0, -1e9).astype(np.float32)
    bias[..., 0] = 0.0
    ref = np.asarray(j_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), attn_mask=jnp.asarray(bias)))
    out = scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                       attn_mask=_t(bias))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    mask = bias == 0
    out_b = scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                         attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out_b.numpy(), ref, **TOL)
    plain = scaled_dot_product_attention(_t(q), _t(k), _t(v))
    no_drop = scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                           dropout_p=0.5, training=False)
    np.testing.assert_array_equal(no_drop.numpy(), plain.numpy())
    ref_drop = sdpa_ref(_t(q), _t(k), _t(v), attn_mask=_t(bias),
                        dropout_p=0.5, training=False)
    np.testing.assert_allclose(ref_drop.numpy(), ref, **TOL)


def test_sdpa_ref_masks_match_reference():
    rng = np.random.RandomState(4)
    q = rng.randn(1, 5, 2, 8).astype(np.float32)
    k = rng.randn(1, 9, 2, 8).astype(np.float32)
    v = rng.randn(1, 9, 2, 8).astype(np.float32)
    mask = rng.rand(1, 1, 5, 9) > 0.3
    mask[..., 0] = True
    ref = np.asarray(j_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), attn_mask=jnp.asarray(mask)))
    out = sdpa_ref(_t(q), _t(k), _t(v), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    ref_c = np.asarray(j_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), is_causal=True))
    np.testing.assert_allclose(
        sdpa_ref(_t(q), _t(k), _t(v), is_causal=True).numpy(), ref_c, **TOL)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference_composition():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    ref = JF.rms_norm(paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(w),
                      epsilon=1e-5).numpy()
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), 1e-5).numpy(), ref,
                               **TOL)
    np.testing.assert_allclose(rmsnorm(_t(x), _t(w), 1e-5).numpy(), ref,
                               **TOL)


def test_rmsnorm_residual_matches_mirror():
    rng = np.random.RandomState(6)
    x = rng.randn(10, 48).astype(np.float32)
    r = rng.randn(10, 48).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    ref_out, ref_rstd = jrms._mirror(jnp.asarray(x), jnp.asarray(r),
                                     jnp.asarray(w), 1e-6, True)
    out, h = rmsnorm_residual(_t(x), _t(r), _t(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(h.numpy(), x + r, **TOL)
    _, _, rstd = rmsnorm_plain(_t(x), _t(w), 1e-6, _t(r))
    np.testing.assert_allclose(rstd.numpy(), np.asarray(ref_rstd)[:, 0],
                               **TOL)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def _bf16_step(ref):
    """One bf16 step (2^-7 relative) at the scale of ``ref``'s largest
    entry."""
    top = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(13, 48), (2, 7, 64), (5, 100)])
def test_layer_norm_plain_matches_pallas_kernel(dtype, shape):
    """Ragged rows (13, 5: not a multiple of the kernel's 8-row block),
    3-D input, an odd width; the reference's kernel in interpret mode."""
    rng = np.random.RandomState(sum(shape))
    x = (2 * rng.randn(*shape) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                       jnp.asarray(b, jd), 1e-5),
                     np.float32)
    td = getattr(torch, dtype)
    got = layernorm(_t(x).to(td), _t(w).to(td), _t(b).to(td), 1e-5)
    assert got.dtype == td and got.shape == shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=_bf16_step(ref), rtol=0)
    _, mean, rstd = layer_norm_plain(_t(x).reshape(-1, shape[-1]), _t(w),
                                     _t(b), 1e-5)
    x2 = x.reshape(-1, shape[-1])
    np.testing.assert_allclose(mean.numpy(), x2.mean(-1), **TOL)
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt(x2.var(-1) + 1e-5), **TOL)


@pytest.mark.parametrize("shape", [(13, 48), (2, 7, 64)])
def test_layer_norm_grads_match_pallas_vjp(shape):
    import jax

    rng = np.random.RandomState(len(shape))
    x = (2 * rng.randn(*shape) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    t = rng.randn(*shape).astype(np.float32)
    ref = jax.grad(lambda a, c, d: jnp.sum(layer_norm_pallas(a, c, d, 1e-5)
                                           * jnp.asarray(t)),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    (layernorm(*leaves, 1e-5) * _t(t)).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **TOL)


def test_layer_norm_functional_matches_reference_composition():
    """Two normalised axes, and no bias: the plain composition, as the
    reference computes it without its kernel."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 4, 5).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    jx, jw = paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(w)
    ref = JF.layer_norm(jx, [4, 5], jw, None, 1e-5).numpy()
    np.testing.assert_allclose(
        layer_norm(_t(x), [4, 5], _t(w), None, 1e-5).numpy(), ref, **TOL)
    w1 = rng.randn(5).astype(np.float32)
    b1 = rng.randn(5).astype(np.float32)
    ref1 = JF.layer_norm(jx, 5, paddle_tpu.to_tensor(w1),
                         paddle_tpu.to_tensor(b1)).numpy()
    np.testing.assert_allclose(
        layer_norm(_t(x), 5, _t(w1), _t(b1)).numpy(), ref1, **TOL)


# ---------------------------------------------------------------------------
# selection rules and the build
# ---------------------------------------------------------------------------

def test_selector_takes_plain_on_cpu_and_refuses_other_devices():
    x = torch.zeros(2, 8)
    assert K.use_kernel(x, x) is False
    with pytest.raises(ValueError):
        K.use_kernel(x, torch.zeros(2, 8, device="meta"))


def test_launch_counters_reset():
    K.LAUNCHES["rmsnorm"] += 3
    assert K.launch_counts()["rmsnorm"] >= 3
    K.reset_launch_counts()
    assert set(K.launch_counts().values()) == {0}
    assert set(K.launch_counts()) == {
        "flash_attention", "flash_attention_dropout", "flash_attention_mask",
        "flash_attention_varlen", "flash_attention_bwd",
        "flash_attention_bwd_dropout", "flash_attention_bwd_mask",
        "flash_attention_bwd_varlen", "layernorm", "paged_attention",
        "rmsnorm", "rmsnorm_bwd", "softmax_ce", "softmax_ce_bwd",
        "ctc_alpha", "ctc_beta", "rnnt_alpha", "rnnt_beta_grad",
        "flash_attention_sm90", "flash_attention_mma",
        "flash_attention_bwd_sm90", "flash_attention_bwd_mma"}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_every_kernel_source_is_present():
    names = {p.stem for p in _build.sources()}
    assert names == {"ctc", "flash_attention", "flash_attention_bwd",
                     "flash_attention_sm90", "flash_attention_bwd_sm90",
                     "flash_attention_sm90_narrow",
                     "flash_attention_bwd_sm90_narrow",
                     "flash_attention_sm90_wide",
                     "flash_attention_bwd_sm90_wide",
                     "flash_attention_bwd_sm90_wider",
                     "layernorm", "paged_attention", "rmsnorm", "rnnt",
                     "softmax_ce"}
