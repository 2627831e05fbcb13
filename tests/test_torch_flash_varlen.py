"""The port's varlen flash attention (``F.flash_attn_unpadded``) against the
JAX package on the CPU.

The reference side is ``_mirror_fwd`` / ``_mirror_bwd`` with the segment
ids of ``_segments_from_cu``, on q, k, v padded to a multiple of 128 as
``flash_attn_varlen_pallas`` pads them (never that entry itself, which
passes through ``x64_off``, ROADMAP R1). f32 throughout; outputs, lse and
gradients agree within atol 1e-5 + rtol 1e-5. Rows with no key to see
(tokens past ``cu[-1]``, or a sequence whose key part is empty) are where
the two differ by design: the port never visits other sequences' keys,
as the reference's kernels skip them by their [lo, hi) tables, and gives
such a row out 0, lse -1e30 and no gradient, while the unblocked mirror
spreads it over every key. Those rows are held to the port's zeros, and
they enter the mirror's backward with lse +inf, which takes them out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (the reference's jax settings)
from paddle_tpu.kernels import flash_attention as jflash

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels.flash_attention import (
    delta_minus_glse, dropout_keep_plain, flash_attn_varlen,
    flash_attn_varlen_bwd_plain, flash_attn_varlen_plain, segments_from_cu)
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
H, D, P = 4, 8, 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, Tq, Tk, hkv):
    rng = np.random.RandomState(seed)
    q = rng.randn(Tq, H, D).astype(np.float32)
    k = rng.randn(Tk, hkv, D).astype(np.float32)
    v = rng.randn(Tk, hkv, D).astype(np.float32)
    g = rng.randn(Tq, H, D).astype(np.float32)
    glse = (0.1 * rng.randn(H, Tq)).astype(np.float32)
    return q, k, v, g, glse


def _live(cu_q, cu_k, Tq):
    """Query rows that see at least one key."""
    live = np.zeros(Tq, bool)
    for a, b, c, d in zip(cu_q[:-1], cu_q[1:], cu_k[:-1], cu_k[1:]):
        live[a:b] = d > c
    return live


def _mirror(q, k, v, g, glse, lse, dg, cu_q, cu_k, causal, live, p=0.0,
            seed=0):
    Tq, Tk, hkv = q.shape[0], k.shape[0], k.shape[1]
    rep = H // hkv
    nseg = len(cu_q) - 1
    qseg = jflash._segments_from_cu(jnp.asarray(cu_q), Tq, P, nseg + 1)
    kseg = jflash._segments_from_cu(jnp.asarray(cu_k), Tk, P, nseg + 2)

    def hsd(x, T):
        x = np.repeat(np.pad(x, ((0, P - T), (0, 0), (0, 0))),
                      H // x.shape[1], axis=1)
        return jnp.asarray(x.transpose(1, 0, 2))

    def pad_rows(x, fill):
        return jnp.asarray(np.pad(x, ((0, 0), (0, P - Tq)),
                                  constant_values=fill)[..., None])

    scale = float(1.0 / np.sqrt(D))
    sd = None if not p else jnp.asarray([seed], jnp.int32)
    out, lse_r = jflash._mirror_fwd(hsd(q, Tq), hsd(k, Tk), hsd(v, Tk), qseg,
                                    kseg, None, sd, causal, scale, p, H)
    lse_b = np.where(live[None], lse, np.inf)      # no-key rows: no gradient
    dq, dk, dv = jflash._mirror_bwd(
        hsd(q, Tq), hsd(k, Tk), hsd(v, Tk), hsd(g, Tq),
        pad_rows(np.zeros_like(glse), 0.0), pad_rows(lse_b, np.inf),
        pad_rows(dg, 0.0), qseg, kseg, None, sd, causal, scale, p, H)

    def kv(x):
        x = np.asarray(x).transpose(1, 0, 2)[:Tk]
        return x.reshape(Tk, hkv, rep, D).sum(2)
    return (np.asarray(out).transpose(1, 0, 2)[:Tq],
            np.asarray(lse_r)[:, :Tq, 0],
            np.asarray(dq).transpose(1, 0, 2)[:Tq], kv(dk), kv(dv))


def _port(q, k, v, g, glse, cu_q, cu_k, causal, p=0.0, seed=0):
    out, lse = flash_attn_varlen_plain(_t(q), _t(k), _t(v), _t(cu_q),
                                       _t(cu_k), causal, None, p, seed)
    dg = delta_minus_glse(out, _t(g), _t(glse))
    grads = flash_attn_varlen_bwd_plain(_t(q), _t(k), _t(v), _t(g), lse, dg,
                                        _t(cu_q), _t(cu_k), causal, None, p,
                                        seed)
    return (out.numpy(), lse.numpy(), *(x.numpy() for x in grads)), dg


def _check(port, ref, live):
    out, lse, dq, dk, dv = port
    np.testing.assert_allclose(out[live], ref[0][live], **TOL)
    np.testing.assert_allclose(lse[:, live], ref[1][:, live], **TOL)
    np.testing.assert_allclose(dq[live], ref[2][live], **TOL)
    np.testing.assert_allclose(dk, ref[3], **TOL)
    np.testing.assert_allclose(dv, ref[4], **TOL)
    assert not out[~live].any() and not dq[~live].any()
    assert (lse[:, ~live] == np.float32(-1e30)).all()


CU = np.array([0, 5, 5, 17, 30], np.int32)    # an empty sequence, tail 30..


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_matches_mirror(causal, hkv):
    q, k, v, g, glse = _inputs(hkv + causal, 34, 34, hkv)
    port, dg = _port(q, k, v, g, glse, CU, CU, causal)
    live = _live(CU, CU, 34)
    _check(port, _mirror(q, k, v, g, glse, port[1], dg.numpy(), CU, CU,
                         causal, live), live)
    assert not port[3][30:].any() and not port[4][30:].any()   # tail keys


def test_varlen_different_q_and_k_lengths_matches_mirror():
    """Non-causal, cu_q != cu_k, GQA, a key part that is empty (sequence 2:
    its queries see nothing) and tails past cu[-1] on both sides."""
    cu_k = np.array([0, 7, 9, 9, 20], np.int32)
    q, k, v, g, glse = _inputs(5, 34, 23, 2)
    port, dg = _port(q, k, v, g, glse, CU, cu_k, False)
    live = _live(CU, cu_k, 34)
    assert not live[5:17].any() and live[17:30].all() and live[:5].all()
    _check(port, _mirror(q, k, v, g, glse, port[1], dg.numpy(), CU, cu_k,
                         False, live), live)


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_dropout_matches_mirror(monkeypatch, causal):
    """Dropout keys its bits on packed positions with bh = h (the
    reference's varlen call has batch 1): the port's keep mask over the
    padded rows, injected into the mirror."""
    def dropmask(seed, BH, Sq, Sk, dropout_p):
        keep = dropout_keep_plain(int(np.asarray(seed)[0]), 1, BH, Sq, Sk,
                                  dropout_p)[0].numpy()
        return jnp.asarray(keep.astype(np.float32)) / (1.0 - dropout_p)

    monkeypatch.setattr(jflash, "_mirror_dropmask", dropmask)
    q, k, v, g, glse = _inputs(9, 34, 34, 2)
    port, dg = _port(q, k, v, g, glse, CU, CU, causal, 0.2, 1234)
    live = _live(CU, CU, 34)
    _check(port, _mirror(q, k, v, g, glse, port[1], dg.numpy(), CU, CU,
                         causal, live, 0.2, 1234), live)
    dense, _ = _port(q, k, v, g, glse, CU, CU, causal)
    assert not np.allclose(port[0], dense[0])                  # it dropped


def test_causal_needs_equal_cu_seqlens():
    q, k, v, _, _ = _inputs(3, 34, 34, 4)
    other = _t(np.array([0, 5, 6, 17, 30], np.int32))
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(CU), other,
                               causal=True)
    with pytest.raises(ValueError, match="start at 0"):
        TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(CU + 1), _t(CU + 1))
    out, _ = TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(CU), other)
    assert out.shape == q.shape


def test_segments_from_cu_match_reference():
    got = segments_from_cu(_t(CU), 34, 5).numpy()
    want = np.asarray(jflash._segments_from_cu(jnp.asarray(CU), 34, 34, 5))[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_unpadded_returns_out_none_and_differentiates(causal):
    """``F.flash_attn_unpadded`` returns ``(out, None)``; its autograd
    gradients are the plain backward's (zeros on the tail), and on the CPU
    it launches no kernel."""
    q, k, v, g, glse = _inputs(21, 34, 34, 2)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    before = K.launch_counts()
    out, soft = TF.flash_attn_unpadded(tq, tk, tv, _t(CU), _t(CU),
                                       max_seqlen_q=12, max_seqlen_k=12,
                                       causal=causal, return_softmax=True)
    assert soft is None
    out.backward(_t(g))
    assert K.launch_counts() == before
    port, _ = _port(q, k, v, g, np.zeros_like(glse), CU, CU, causal)
    np.testing.assert_array_equal(out.detach().numpy(), port[0])
    for got, want in zip((tq.grad, tk.grad, tv.grad), port[2:]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not tq.grad[30:].any() and not tk.grad[30:].any()
    o2, lse = flash_attn_varlen(_t(q), _t(k), _t(v), _t(CU), _t(CU), causal)
    assert lse.shape == (H, 34)
    off, _ = TF.flash_attn_unpadded(_t(q), _t(k), _t(v), _t(CU), _t(CU),
                                    dropout=0.5, causal=causal,
                                    training=False)
    np.testing.assert_array_equal(off.numpy(), port[0])
