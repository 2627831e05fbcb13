"""ResNet-18 in the PyTorch port (paddle_tpu_torch.vision) against the
JAX package, on the CPU in f32, with the reference's weights and
batch-norm buffers through ``vision_state_from_jax``
(``tests/test_torch_vision_resnet50.py`` holds ResNet-50).

ResNet-18 (10 classes) takes one training-mode forward and backward of a
seeded 2 x 3 x 64 x 64 batch (64 px, so ``layer4`` keeps a 2 x 2 map and
its batch statistics span 8 values) and the cross-entropy loss, then an
eval forward on the updated buffers. Tolerances (XLA and torch sum
convolutions and batch statistics in different orders):

- logits and losses: atol = rtol = 1e-4;
- every gradient: relative L2 error below 1e-4;
- the batch norms' running buffers after the step: atol = rtol = 1e-5;
- a 3-step Momentum (L2 1e-4) + PiecewiseDecay loop: each loss within
  atol = rtol = 1e-4.

The reference builds and runs the model once per module (its first
forward and backward compile every op).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.optimizer.lr import PiecewiseDecay as JPiecewiseDecay
from paddle_tpu.vision.models import resnet18 as j_resnet18

from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
from paddle_tpu_torch.vision.models import resnet18

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
BUF = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _j(a):
    return paddle_tpu.to_tensor(np.ascontiguousarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(jbuild, tbuild, seed):
    paddle_tpu.seed(seed)
    jm = jbuild(num_classes=10)
    arrays = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    arrays.update({n: np.asarray(b.numpy()) for n, b in jm.named_buffers()})
    tm = tbuild(num_classes=10, device="cpu")
    missing, unexpected = tm.load_state_dict(vision_state_from_jax(arrays,
                                                                   tm))
    assert not missing and not unexpected
    return jm, tm


def _batch(seed, B=2, size=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 3, size, size).astype(np.float32)
    y = rng.randint(0, 10, (B, 1)).astype(np.int64)
    return x, y


def _tgrads(tm):
    """The port's gradients in the reference's layouts."""
    out = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        owner = tm.get_submodule(n.rpartition(".")[0])
        out[n] = g.T if isinstance(owner, torch.nn.Linear) and \
            n.endswith("weight") else g
    return out


def _run(jbuild, tbuild, seed, dtype=np.float32):
    """One training-mode step's logits, loss, gradients and buffers in both
    packages, then eval logits on the updated buffers; in ``dtype`` (both
    packages' parameters, buffers and inputs)."""
    jm, tm = _models(jbuild, tbuild, seed)
    if dtype == np.float64:
        for t in list(jm.parameters()) + [b for _, b in jm.named_buffers()]:
            t._value = t._value.astype(np.float64)
        tm = tm.double()
    x, y = _batch(seed)
    x = x.astype(dtype)
    jlog = jm(_j(x))
    jloss = JF.cross_entropy(jlog, _j(y))
    jloss.backward()
    tlog = tm(_t(x))
    tloss = TF.cross_entropy(tlog, _t(y))
    tloss.backward()
    jm.eval()
    tm.eval()
    xe = _batch(seed + 1)[0].astype(dtype)
    with torch.no_grad():
        teval = tm(_t(xe)).numpy()
    return {
        "logits": (np.asarray(jlog.numpy()), tlog.detach().numpy()),
        "loss": (float(jloss.numpy()), tloss.item()),
        "grads": ({n: np.asarray(p.grad.numpy())
                   for n, p in jm.named_parameters()}, _tgrads(tm)),
        "buffers": ({n: np.asarray(b.numpy()) for n, b in jm.named_buffers()},
                    {n: b.numpy() for n, b in tm.named_buffers()}),
        "eval": (np.asarray(jm(_j(xe)).numpy()), teval),
    }


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def run18():
    return _run(j_resnet18, resnet18, 3)


def test_resnet18_logits_and_loss_match_reference(run18):
    np.testing.assert_allclose(run18["logits"][1], run18["logits"][0], **TOL)
    np.testing.assert_allclose(run18["loss"][1], run18["loss"][0], **TOL)


def test_resnet18_every_gradient_matches_reference(run18):
    jg, tg = run18["grads"]
    assert set(tg) == set(jg) and len(jg) == 62
    rel = {n: rel_l2(tg[n], jg[n]) for n in jg}
    worst = max(rel, key=rel.get)
    assert rel[worst] < GRAD_REL_L2, (worst, rel[worst])


def test_resnet18_bn_buffers_after_a_step_match_reference(run18):
    jb, tb = run18["buffers"]
    assert set(tb) == set(jb) and len(jb) == 40
    for n in jb:
        np.testing.assert_allclose(tb[n], jb[n], err_msg=n, **BUF)


def test_resnet18_eval_logits_match_reference(run18):
    """Eval mode normalises with the running buffers the step left."""
    np.testing.assert_allclose(run18["eval"][1], run18["eval"][0], **TOL)


def test_resnet18_momentum_piecewise_loop_matches_reference():
    """The recipe's optimizer (Momentum 0.9, L2 1e-4) over PiecewiseDecay
    0.1 -> 0.01 -> 0.001, the schedule stepped after each step: the same
    loss sequence, falling."""
    jm, tm = _models(j_resnet18, resnet18, 5)
    x, y = _batch(5)
    bounds, values = [1, 2], [0.1, 0.01, 0.001]
    jsched = JPiecewiseDecay(bounds, values)
    tsched = PiecewiseDecay(bounds, values)
    jopt = JMomentum(learning_rate=jsched, momentum=0.9,
                     parameters=jm.parameters(), weight_decay=1e-4)
    topt = Momentum(learning_rate=tsched, momentum=0.9,
                    parameters=tm.parameters(), weight_decay=1e-4)
    jl, tl = [], []
    for _ in range(3):
        loss = JF.cross_entropy(jm(_j(x)), _j(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        jl.append(float(loss.numpy()))
        loss = TF.cross_entropy(tm(_t(x)), _t(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tsched.step()
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


def test_resnet_refuses_pretrained():
    with pytest.raises(ValueError, match="download"):
        resnet18(pretrained=True, device="cpu")


def test_vision_slice_runs_with_jax_unimportable():
    """The vision slice imports and trains a ResNet-18 step (O1, Momentum
    over PiecewiseDecay, CrossEntropyLoss) in a process where importing
    jax or paddle_tpu raises."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch import amp, nn\n"
        "from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay\n"
        "from paddle_tpu_torch.vision.models import (resnet18,\n"
        "                                            mobilenet_v3_small)\n"
        "m = resnet18(num_classes=10, device='cpu', seed=0)\n"
        "sched = PiecewiseDecay([1], [0.1, 0.01])\n"
        "opt = Momentum(learning_rate=sched, momentum=0.9,\n"
        "               parameters=m.parameters(), weight_decay=1e-4)\n"
        "x, y = torch.randn(2, 3, 32, 32), torch.tensor([[1], [7]])\n"
        "for _ in range(2):\n"
        "    with amp.auto_cast(level='O1'):\n"
        "        loss = nn.CrossEntropyLoss()(m(x), y)\n"
        "    loss.backward(); opt.step(); opt.clear_grad(); sched.step()\n"
        "mobilenet_v3_small(scale=0.5, device='cpu').eval()(x)\n"
        "print('ok', round(loss.item(), 3))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
