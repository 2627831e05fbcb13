"""Kernel modules of the PyTorch port (paddle_tpu_torch.kernels) against the
JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold that version against the JAX package's own plain paths (the Pallas
entry points raise on this tree's jax, ROADMAP R1): ``paged_attention_ref``,
the flash kernel's ``_mirror_fwd``, ``sdpa_ref``, the ``F.rms_norm``
composition and ``rmsnorm._mirror``. Inputs come from a numpy seed and go
to both packages; f32 throughout, atol = rtol = 1e-5 (the summation order
differs between XLA and torch).

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
from paddle_tpu.kernels.paged_attention import paged_attention_ref
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import sdpa_ref as j_sdpa_ref

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.kernels.rmsnorm import (
    rmsnorm, rmsnorm_plain, rmsnorm_residual)
from paddle_tpu_torch.nn.functional import (
    rms_norm, scaled_dot_product_attention, sdpa_ref)

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
    assert set(K.launch_counts()) == {"flash_attention", "paged_attention",
                                      "rmsnorm"}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_every_kernel_source_is_present():
    names = {p.stem for p in _build.sources()}
    assert names == {"flash_attention", "paged_attention", "rmsnorm"}
