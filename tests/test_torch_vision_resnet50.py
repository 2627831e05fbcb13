"""ResNet-50 in the PyTorch port (paddle_tpu_torch.vision) against the JAX
package, on the CPU, with the reference's weights and batch-norm buffers
through ``vision_state_from_jax``: one training-mode forward and backward
of a seeded 2 x 3 x 64 x 64 batch (``layer4`` keeps a 2 x 2 map), the
cross-entropy loss, then an eval forward on the updated buffers.

At its initialisation ResNet-50's training-mode step is badly conditioned
in f32: its 53 batch norms (no zero-initialised last gamma in Paddle's
ResNet) amplify rounding through depth, and an f32 run of EITHER package
carries about 1e-4 relative error in the logits and a few per cent in
the worst parameter's gradient against an f64 run (the last test here
computes both packages' errors). So the parity of the two packages is
held in f64, where it is tight, and the f32 path is held to be as
accurate as the reference's:

- f64 (both packages' parameters, buffers and inputs): logits and eval
  logits atol = rtol = 1e-9; the batch norms' running buffers atol = rtol
  = 1e-10; the loss atol = rtol = 1e-6 and every gradient relative L2
  below 1e-6 (both cross-entropies compute the softmax in f32, so the
  loss and the gradients carry its rounding: ~1e-7);
- f32: the port's relative L2 error against the f64 result, of the
  logits and of all the gradients together, at most twice the
  reference's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.vision.models import resnet50 as j_resnet50

from paddle_tpu_torch.vision.models import resnet50, resnet_flops_per_image
from tests.test_torch_vision_resnet import _run, rel_l2

torch.set_num_threads(2)
F64 = dict(atol=1e-9, rtol=1e-9)
F64_BUF = dict(atol=1e-10, rtol=1e-10)
F64_GRAD_REL_L2 = 1e-6


@pytest.fixture(scope="module")
def run64():
    return _run(j_resnet50, resnet50, 4, np.float64)


@pytest.fixture(scope="module")
def run32():
    return _run(j_resnet50, resnet50, 4, np.float32)


def test_resnet50_logits_and_loss_match_reference_f64(run64):
    np.testing.assert_allclose(run64["logits"][1], run64["logits"][0], **F64)
    np.testing.assert_allclose(run64["loss"][1], run64["loss"][0],
                               atol=1e-6, rtol=1e-6)


def test_resnet50_every_gradient_matches_reference_f64(run64):
    jg, tg = run64["grads"]
    assert set(tg) == set(jg) and len(jg) == 161
    rel = {n: rel_l2(tg[n], jg[n]) for n in jg}
    worst = max(rel, key=rel.get)
    assert rel[worst] < F64_GRAD_REL_L2, (worst, rel[worst])


def test_resnet50_bn_buffers_after_a_step_match_reference_f64(run64):
    jb, tb = run64["buffers"]
    assert set(tb) == set(jb) and len(jb) == 106
    for n in jb:
        np.testing.assert_allclose(tb[n], jb[n], err_msg=n, **F64_BUF)


def test_resnet50_eval_logits_match_reference_f64(run64):
    np.testing.assert_allclose(run64["eval"][1], run64["eval"][0], **F64)


def _all(grads):
    return np.concatenate([grads[n].ravel() for n in sorted(grads)])


def test_resnet50_f32_is_as_accurate_as_the_reference(run32, run64):
    """Against the f64 result (the port's, which the f64 tests hold to the
    reference's), the port's f32 logits and gradients err by at most twice
    what the reference's f32 ones do."""
    truth = run64["logits"][1]
    ref, port = (rel_l2(run32["logits"][i], truth) for i in (0, 1))
    assert port <= 2 * ref, (port, ref)
    truth = _all(run64["grads"][1])
    ref, port = (rel_l2(_all(run32["grads"][i]), truth) for i in (0, 1))
    assert port <= 2 * ref, (port, ref)
    for i in (0, 1):            # the f32 runs agree with f64 to ~1e-4
        np.testing.assert_allclose(run32["loss"][i], run64["loss"][1],
                                   atol=1e-3, rtol=1e-3)


def test_resnet50_flops_per_image():
    """About 4.09 G multiply-adds a 224 x 224 image (the published
    ResNet-50 count), 25.56 M parameters, 53 batch norms."""
    m = resnet50(device="cpu", seed=0)
    macs = resnet_flops_per_image(m) / 2
    assert 4.08e9 < macs < 4.10e9
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
    assert len(list(m.buffers())) == 106
    assert m.training                       # restored after the count
