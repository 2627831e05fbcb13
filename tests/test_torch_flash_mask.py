"""The port's flash attention with a bool mask, and at any head width,
against the JAX package on the CPU.

The reference side is ``paddle_tpu.kernels.flash_attention._mirror_fwd`` /
``_mirror_bwd`` (the Pallas kernels' arithmetic, unblocked) fed by
``_canon_mask``, never ``flash_attention_pallas``, which passes through
``x64_off`` (ROADMAP R1). The mirror runs in f32 (the scale is handed over
as a Python float, so it stays weakly typed). Inputs are seeded numpy
arrays; outputs, lse and gradients of the f32 plain versions agree within
atol 1e-5 + rtol 1e-5 (the same f32 arithmetic in another summation
order), masked and fully masked rows included: a row whose every visible
key is masked averages V over the causally hidden keys (over all keys
without causality) in both. Dropout cases inject the port's keep mask
into the mirror through ``_mirror_dropmask``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.kernels import flash_attention as jflash

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels.flash_attention import (
    MASKED, delta_minus_glse, dropout_keep_plain, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_plain, mask_view)
from paddle_tpu_torch.models.convert import ernie_state_from_jax
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, H, D = 2, 37, 4, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bhsd(x, b, h):
    x = np.asarray(x)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _inputs(seed, hkv=H, d=D, sq=S, sk=S):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, H, d).astype(np.float32)
    k = rng.randn(B, sk, hkv, d).astype(np.float32)
    v = rng.randn(B, sk, hkv, d).astype(np.float32)
    g = rng.randn(B, sq, H, d).astype(np.float32)
    glse = (0.1 * rng.randn(B, H, sq)).astype(np.float32)
    return rng, q, k, v, g, glse


def _mirror(q, k, v, g, glse, lse, mask, mode, causal, p=0.0, seed=0):
    """The reference's forward and backward (GQA by repeating KV heads,
    dK/dV summed back) on [B, S, H, D] numpy inputs."""
    hkv = k.shape[2]
    rep = H // hkv
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    sd = None if not p else jnp.asarray([seed], jnp.int32)
    out, lse_r = jflash._mirror_fwd(_bhsd(q), _bhsd(kr), _bhsd(vr), None, None,
                                    mask, sd, causal, scale, p, H, mode)
    delta = (g * np.asarray(_from_bhsd(out, B, H))).sum(-1)
    dq, dk, dv = jflash._mirror_bwd(
        _bhsd(q), _bhsd(kr), _bhsd(vr), _bhsd(g),
        jnp.asarray(glse.reshape(B * H, -1, 1)),
        jnp.asarray(lse.reshape(B * H, -1, 1)),
        jnp.asarray(delta.transpose(0, 2, 1).reshape(B * H, -1, 1)),
        None, None, mask, sd, causal, scale, p, H, mode)
    sk = k.shape[1]

    def kv(x):
        return _from_bhsd(x, B, H).reshape(B, sk, hkv, rep, -1).sum(3)
    return (_from_bhsd(out, B, H), np.asarray(lse_r).reshape(B, H, -1),
            _from_bhsd(dq, B, H), kv(dk), kv(dv))


def _port(q, k, v, g, glse, mask, causal, p=0.0, seed=0):
    out, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal, None, p,
                                     seed, mask)
    dg = delta_minus_glse(out, _t(g), _t(glse))
    grads = flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(g), lse, dg,
                                      causal, None, p, seed, mask)
    return (out.numpy(), lse.numpy(), *(x.numpy() for x in grads))


def _check(port, ref):
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), port, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


# the mask shapes `_canon_mask` takes, one per broadcast mode, with row dim
# 1 or Sq and key dim 1 or Sk
SHAPES = [(1, 1, 1, S), (B, 1, 1, S), (1, H, S, S), (B, H, S, S),
          (B, 1, S, 1), (S, S)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_mask_modes_match_mirror(shape, causal):
    rng, q, k, v, g, glse = _inputs(len(shape) + shape[0] + shape[1])
    m = rng.rand(*shape) > 0.3
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, S, S)
    port = _port(q, k, v, g, glse, torch.from_numpy(m), causal)
    _check(port, _mirror(q, k, v, g, glse, port[1], jm, mode, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_matches_mirror(causal):
    """Row 5 of batch 0, head 1 sees no unmasked key: the mirror (and so the
    port) averages V over the causally hidden keys, or over every key
    without causality; its lse is -1e30 or MASKED."""
    rng, q, k, v, g, glse = _inputs(11)
    m = rng.rand(B, H, S, S) > 0.3
    m[0, 1, 5, :] = False
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, S, S)
    port = _port(q, k, v, g, glse, torch.from_numpy(m), causal)
    _check(port, _mirror(q, k, v, g, glse, port[1], jm, mode, causal))
    lse = port[1][0, 1, 5]
    assert lse == (np.float32(-1e30) if causal else np.float32(MASKED))
    vr = v[0, :, 1 // (H // v.shape[2])]
    want = vr[6:].mean(0) if causal else vr.mean(0)
    np.testing.assert_allclose(port[0][0, 5, 1], want, **TOL)


# causal only at Sq == Sk: the mirror's causality is q_ids >= k_ids, the
# port's (the reference's sdpa_ref) the bottom-right diagonal; they agree
# there
@pytest.mark.parametrize("causal,sq", [(False, 29), (True, 37)])
def test_mask_with_gqa_and_ragged_keys_matches_mirror(causal, sq):
    rng, q, k, v, g, glse = _inputs(13, hkv=2, sq=sq, sk=37)
    m = rng.rand(B, 1, 1, 37) > 0.4
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, sq, 37)
    port = _port(q, k, v, g, glse, torch.from_numpy(m), causal)
    _check(port, _mirror(q, k, v, g, glse, port[1], jm, mode, causal))


@pytest.mark.parametrize("mode", ["one", "batch", "head", "bh"])
def test_canonical_mask_with_its_mode(mode):
    """The reference's canonical [N, 1|Sq, Sk] with its mode; B == H here,
    so only the mode tells a batch mask from a head mask."""
    rng, q, k, v, g, glse = _inputs(17)
    b, h = B, B          # B == H
    q, g, glse = q[:, :, :h], g[:, :, :h], glse[:, :h]
    k, v = k[:, :, :h], v[:, :, :h]
    n = {"one": 1, "batch": b, "head": h, "bh": b * h}[mode]
    m = rng.rand(n, S, S) > 0.3
    jm = jnp.where(jnp.asarray(m), 0.0, -1e30).astype(jnp.bfloat16)
    m4 = mask_view(torch.from_numpy(m), b, h, S, S, mode)
    out, lse = flash_attention_plain(_t(q), _t(k), _t(v), True, mask=m4)
    scale = float(1.0 / np.sqrt(D))
    ref, ref_lse = jflash._mirror_fwd(_bhsd(q), _bhsd(k), _bhsd(v), None,
                                      None, jm, None, True, scale, 0.0, h,
                                      mode)
    np.testing.assert_allclose(out.numpy(), _from_bhsd(ref, b, h), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(b, h, S), **TOL)


def _mirror_mask(b, h):
    def dropmask(seed, BH, Sq, Sk, dropout_p):
        keep = dropout_keep_plain(int(np.asarray(seed)[0]), b, h, Sq, Sk,
                                  dropout_p).reshape(BH, Sq, Sk).numpy()
        return jnp.asarray(keep.astype(np.float32)) / (1.0 - dropout_p)
    return dropmask


@pytest.mark.parametrize("causal", [False, True])
def test_mask_with_dropout_matches_mirror(monkeypatch, causal):
    rng, q, k, v, g, glse = _inputs(19)
    m = rng.rand(B, 1, S, S) > 0.3
    m[1, 0, 3] = False
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, S, S)
    monkeypatch.setattr(jflash, "_mirror_dropmask", _mirror_mask(B, H))
    port = _port(q, k, v, g, glse, torch.from_numpy(m), causal, 0.2, 99)
    _check(port, _mirror(q, k, v, g, glse, port[1], jm, mode, causal, 0.2,
                         99))


def test_mask_view_broadcasts_without_copies():
    m = torch.rand(B, 1, 1, S) > 0.5
    v4 = mask_view(m, B, H, S, S)
    assert v4.shape == (B, H, S, S) and v4.stride() == (S, 0, 0, 1)
    assert v4.data_ptr() == m.data_ptr()
    v3 = mask_view(torch.ones(H, 1, S, dtype=torch.bool), B, H, S, S, "head")
    assert v3.stride()[0] == 0
    with pytest.raises(ValueError):
        mask_view(torch.ones(3, 1, S, dtype=torch.bool), B, H, S, S)
    with pytest.raises(ValueError):
        mask_view(torch.ones(B * H, S, S, dtype=torch.bool), B, H, S, S,
                  "head")
    with pytest.raises(TypeError):
        mask_view(torch.ones(S, S), B, H, S, S)


def test_sdpa_bool_mask_takes_the_flash_path_and_differentiates():
    """A bool mask goes to the flash Function (the plain version on the CPU:
    the mirror's masking), differentiable in q, k and v, launching nothing
    here; a float mask still goes to sdpa_ref."""
    rng, q, k, v, g, glse = _inputs(23)
    m = rng.rand(B, 1, 1, S) > 0.3
    m[..., 0] = True
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    before = K.launch_counts()
    out = TF.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(m))
    out.backward(_t(g))
    assert K.launch_counts() == before
    want, _ = flash_attention_fwd(_t(q), _t(k), _t(v),
                                  mask=torch.from_numpy(m))
    np.testing.assert_array_equal(out.detach().numpy(), want.numpy())
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, S, S)
    port = _port(q, k, v, g, glse * 0, torch.from_numpy(m), False)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), port[2:]):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    bias = np.where(m, 0.0, -1e9).astype(np.float32)
    np.testing.assert_allclose(
        TF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                        attn_mask=_t(bias)).numpy(),
        TF.sdpa_ref(_t(q), _t(k), _t(v), attn_mask=_t(bias)).numpy(),
        rtol=0, atol=0)


def test_flash_attention_api_shape():
    """``F.flash_attention`` returns ``(out, None)`` as the reference's."""
    _, q, k, v, _, _ = _inputs(29)
    out, soft = TF.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                   return_softmax=True)
    assert soft is None
    ref, _ = flash_attention_plain(_t(q), _t(k), _t(v), True)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


# the head_dim sweep of the plain versions: odd, multiples of 8 and 16, the
# Conformer's 36 and its sm90 class 48, past 128 and the top class
@pytest.mark.parametrize("d", [7, 8, 16, 24, 36, 40, 48, 96, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_sweep_matches_mirror(d, causal):
    rng, q, k, v, g, glse = _inputs(d, hkv=2, d=d, sq=21, sk=21)
    m = rng.rand(B, 1, 1, 21) > 0.2
    jm, mode = jflash._canon_mask(jnp.asarray(m), B, H, 21, 21)
    port = _port(q, k, v, g, glse, torch.from_numpy(m), causal)
    _check(port, _mirror(q, k, v, g, glse, port[1], jm, mode, causal))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_with_bool_padding_mask_matches_reference(normalize_before):
    """``nn.TransformerEncoder`` with a bool key-padding mask against the
    reference's on weights carried across. The reference layer runs
    ``sdpa_ref`` on the CPU, equal to the mirror on every row that is not
    fully masked, and this mask leaves every row a key."""
    from paddle_tpu.nn import TransformerEncoder as JEnc
    from paddle_tpu.nn import TransformerEncoderLayer as JLayer
    from paddle_tpu_torch.nn import TransformerEncoder as TEnc
    from paddle_tpu_torch.nn import TransformerEncoderLayer as TLayer

    paddle_tpu.seed(3)
    jenc = JEnc(JLayer(32, 4, 64, dropout=0.0, activation="gelu",
                       normalize_before=normalize_before), 2)
    rng = np.random.RandomState(3)
    params = {}
    for name, p in jenc.named_parameters():
        a = np.asarray(p._value)
        if "norm" in name:
            a = (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
            p._value = jnp.asarray(a)
        params[name] = a
    tenc = TEnc(TLayer(32, 4, 64, dropout=0.0, activation="gelu",
                       normalize_before=normalize_before, device="cpu"), 2)
    tenc.load_state_dict(ernie_state_from_jax(params, tenc))
    x = rng.randn(2, 11, 32).astype(np.float32)
    lengths = np.array([11, 6])
    mask = (np.arange(11)[None, :] < lengths[:, None])[:, None, None, :]
    want = jenc(paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(mask)).numpy()
    got = tenc(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-4)
