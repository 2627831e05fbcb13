"""DenseNet-121 in the port (``paddle_tpu_torch.vision.models.densenet``,
written in Paddle's dygraph idiom over ``nn.Layer`` and the op library)
against the JAX package's, on the CPU.

The reference's weights reach the port through a file (``paddle.save``
of its ``state_dict``, ``paddle.load`` and ``set_state_dict``: ROADMAP
F4, no converter). One training-mode step on a seeded 2 x 3 x 64 x 64
batch (the last block keeps a 2 x 2 map; at 32 px it is 1 x 1, its batch
norms' statistics span 2 values a channel, and the two packages' orders
of summation land 1e-6 apart there) in f64 in both packages: the reference's through
its jitted functional path (``functional_call``, ``jax.value_and_grad``,
``Momentum.apply_gradients``), the port's in the dygraph idiom (Tensors
from ``to_tensor``, ``loss.backward()``, ``opt.step()``). Tolerances, as
``tests/test_torch_vision_resnet50.py`` holds ResNet-50 in f64 (its
batch norms make an f32 step at initialisation undetermined to a few per
cent in either package, ROADMAP C2): logits atol = rtol = 1e-9; the
loss atol = rtol = 1e-6 and every gradient's relative L2 error below
1e-6 (both cross-entropies take the softmax in f32); the batch norms'
running buffers atol = rtol = 1e-10; every parameter after the Momentum
step (0.9, L2 1e-4, lr 0.1) within the gradients' relative L2 1e-6 (a
zero-initialised bias after one step is ``-lr`` times its gradient);
eval logits after it (large: one step at lr 0.1 from initialisation)
within relative L2 1e-6 for the same reason.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as J
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call, functional_state
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision.models import densenet121 as j_densenet121

import paddle_tpu_torch as T
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.vision.models import (densenet121,
                                            densenet_flops_per_image)

torch.set_num_threads(2)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    prev = tdevice._state["device"]
    T.set_device("cpu")
    try:
        return _run(tmp_path_factory.mktemp("densenet"))
    finally:
        tdevice._state["device"] = prev


def _run(tmp):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64)
    y = rng.randint(0, 10, (2, 1)).astype(np.int64)
    xe = rng.randn(2, 3, 64, 64)
    J.seed(3)
    jm = j_densenet121(num_classes=10)
    J.save(jm.state_dict(), str(tmp / "ref.pdparams"))
    params, buffers = functional_state(jm)
    params = {k: v.astype(jnp.float64) for k, v in params.items()}
    buffers = {k: v.astype(jnp.float64) for k, v in buffers.items()}
    jopt = JMomentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)

    def step(p, b):
        def loss_of(p_):
            out, nb = functional_call(jm, p_, b, jnp.asarray(x),
                                      training=True)
            loss = JF.cross_entropy(J.Tensor._wrap(out),
                                    J.Tensor._wrap(jnp.asarray(y)))
            return loss._value, (out, nb)

        (loss, (out, nb)), g = jax.value_and_grad(loss_of, has_aux=True)(p)
        newp, _ = jopt.apply_gradients(p, g, jopt.init_state_tree(p))
        ev, _ = functional_call(jm, newp, nb, jnp.asarray(xe),
                                training=False)
        return loss, out, g, nb, newp, ev

    jl, jout, jg, jb, jp, jev = jax.jit(step)(params, buffers)

    tm = densenet121(num_classes=10)
    missing, unexpected = tm.set_state_dict(T.load(str(tmp / "ref.pdparams")))
    assert not missing and not unexpected
    tm = tm.double()
    topt = T.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=tm.parameters(),
                                weight_decay=1e-4)
    xt, yt = T.to_tensor(x), T.to_tensor(y)
    tout = tm(xt)
    tloss = T.nn.functional.cross_entropy(tout, yt)
    tloss.backward()
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    topt.step()
    topt.clear_grad()
    tm.eval()
    with T.no_grad():
        tev = tm(T.to_tensor(xe))
    with T.no_grad():       # the same model on plain tensors: plain out
        plain = tm(torch.from_numpy(xe))
    return {"types": (type(tout), type(tloss), type(tev), type(plain)),
            "logits": (np.asarray(jout), tout.detach().numpy()),
            "loss": (float(jl), tloss.item()),
            "grads": ({k: np.asarray(v) for k, v in jg.items()}, tg),
            "buffers": ({k: np.asarray(v) for k, v in jb.items()},
                        {n: b.numpy() for n, b in tm.named_buffers()}),
            "params": ({k: np.asarray(v) for k, v in jp.items()},
                       {n: p.detach().numpy()
                        for n, p in tm.named_parameters()}),
            "eval": (np.asarray(jev), tev.numpy(), plain.numpy())}


def test_densenet121_dygraph_outputs_are_port_tensors(run):
    assert run["types"][:3] == (T.Tensor,) * 3
    assert run["types"][3] is torch.Tensor
    np.testing.assert_array_equal(run["eval"][2], run["eval"][1])


def test_densenet121_logits_and_loss_match_reference_f64(run):
    np.testing.assert_allclose(run["logits"][1], run["logits"][0],
                               atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(run["loss"][1], run["loss"][0], atol=1e-6,
                               rtol=1e-6)


def test_densenet121_every_gradient_matches_reference_f64(run):
    jg, tg = run["grads"]
    assert set(tg) == set(jg) and len(jg) == 364
    rel = {n: rel_l2(tg[n], jg[n]) for n in jg}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-6, (worst, rel[worst])


def test_densenet121_bn_buffers_after_the_step_match_reference_f64(run):
    jb, tb = run["buffers"]
    assert set(tb) == set(jb) and len(jb) == 242
    for n in jb:
        np.testing.assert_allclose(tb[n], jb[n], atol=1e-10, rtol=1e-10,
                                   err_msg=n)


def test_densenet121_momentum_step_and_eval_match_reference_f64(run):
    jp, tp = run["params"]
    rel = {n: rel_l2(tp[n], jp[n]) for n in jp if np.any(jp[n])}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-6, (worst, rel[worst])
    assert rel_l2(run["eval"][1], run["eval"][0]) < 1e-6


def _macs_by_hand(size=224, classes=1000):
    """DenseNet-121's multiply-adds from its structure alone."""
    hw = (size // 2) ** 2
    macs = hw * 64 * 3 * 49                     # the 7 x 7 stem, stride 2
    hw = (size // 4) ** 2                       # after the max pool
    c = 64
    for bi, n in enumerate((6, 12, 24, 16)):
        for _ in range(n):
            macs += hw * 128 * c                # 1 x 1 to 4 x growth
            macs += hw * 32 * 128 * 9           # 3 x 3 to growth
            c += 32
        if bi != 3:
            macs += hw * (c // 2) * c           # the transition's 1 x 1
            c //= 2
            hw //= 4                            # its 2 x 2 average pool
    return macs + c * classes


def test_densenet121_published_size_and_flops():
    m = densenet121()
    assert sum(p.numel() for p in m.parameters()) == 7978856
    assert densenet_flops_per_image(m) == 2 * _macs_by_hand()
    assert [type(p) for p in m.parameters()] == [T.Parameter] * 364


def test_eager_slice_runs_with_jax_unimportable():
    """The eager API and DenseNet's dygraph loop import and run in a
    process where importing jax or paddle_tpu raises."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "m = paddle.vision.models.densenet121(num_classes=10, seed=0)\n"
        "opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,\n"
        "                                parameters=m.parameters())\n"
        "x = paddle.to_tensor(np.random.rand(2, 3, 32, 32).astype('f4'))\n"
        "y = paddle.to_tensor(np.array([[1], [7]]))\n"
        "with paddle.amp.auto_cast(level='O1', dtype='bfloat16'):\n"
        "    loss = paddle.nn.functional.cross_entropy(m(x), y)\n"
        "loss.backward(); opt.step(); opt.clear_grad()\n"
        "assert type(loss) is paddle.Tensor\n"
        "print('ok', paddle.op_coverage()['registered'])\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok 408")
