"""``nn.functional.rms_norm`` against the JAX package's on the CPU: amp
O1 and dtype promotion (ROADMAP Queue 3, F2), ``weight=None`` and
``axis``.

The reference computes ``normalize(x).astype(x.dtype) * w``, which
promotes (a bf16 x with an f32 weight gives f32), and its dispatcher casts
bf16 inputs of black-list ops such as ``rms_norm`` to f32 under O1. The
port casts in the functional and keeps its kernel's same-dtype contract.
Without O1, where a bf16 value is involved, the two may round
``normalize(x)`` one bf16 step apart (the kernel multiplies by rsqrt, the
reference divides by sqrt), so those cases agree to a bf16 step (atol
2e-2, rtol 1e-2 at |out| of a few); f32 ones (all O1 cases) within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(xd, wd, shape=(4, 6, 64), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.3 * rng.randn(shape[-1])).astype(np.float32)
    jx = paddle_tpu.to_tensor(x).astype(xd)
    jw = paddle_tpu.to_tensor(w).astype(wd)
    tx = torch.from_numpy(x).to(DT[xd])
    tw = torch.from_numpy(w).to(DT[wd])
    return jx, jw, tx, tw


def _close(got, want, exact):
    want = np.asarray(want.astype("float32").numpy())
    tol = F32_TOL if exact else BF16_TOL
    np.testing.assert_allclose(got.float().detach().numpy(), want, **tol)


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16"),
                                   ("bfloat16", "bfloat16")])
def test_rms_norm_dtype_and_values_match_reference(xd, wd, o1):
    jx, jw, tx, tw = _pair(xd, wd)
    with jamp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
        want = JF.rms_norm(jx, jw, 1e-6)
    with amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
        got = TF.rms_norm(tx, tw, 1e-6)
    assert str(got.dtype).split(".")[-1] == str(want.dtype).split(".")[-1]
    _close(got, want, o1 or xd == wd == "float32")


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("axis", [-1, 1, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_rms_norm_weight_none_and_axis_match_reference(weighted, axis, o1):
    """``weight=None`` and an axis other than the last take the
    reference's composition (its weight broadcasts against the last dim)."""
    jx, jw, tx, tw = _pair("bfloat16", "float32", shape=(6, 6, 6), seed=3)
    jw, tw = (jw, tw) if weighted else (None, None)
    with jamp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
        want = JF.rms_norm(jx, jw, 1e-5, axis=axis)
    with amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
        got = TF.rms_norm(tx, tw, 1e-5, axis=axis)
    assert str(got.dtype).split(".")[-1] == str(want.dtype).split(".")[-1]
    _close(got, want, o1)


def test_rms_norm_layer_under_o1_differentiates_in_f32():
    """``nn.RMSNorm`` (f32 weight) on a bf16 input under O1: the output is
    f32 and both gradients flow, the weight's in f32 (F2 made the kernel
    wrapper raise here on the card)."""
    layer = RMSNorm(64, device="cpu")
    x = torch.randn(3, 64).bfloat16().requires_grad_()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = layer(x)
    assert out.dtype == torch.float32
    out.square().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and layer.weight.grad.dtype \
        == torch.float32
    ref = x.detach().float()
    ref = ref * torch.rsqrt(ref.square().mean(-1, keepdim=True) + 1e-6)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **F32_TOL)
