"""The vision zoo in the PyTorch port (paddle_tpu_torch.vision.models)
against the JAX package, on the CPU in f32, with the reference's weights
and batch-norm buffers through ``vision_state_from_jax``.

Each model's eval forward (dropout off, batch norms on their running
buffers) of a seeded batch: LeNet at 2 x 1 x 28 x 28, AlexNet at 64 px
(its three stride-2 pools need 63), VGG-11 (10 classes) and the
MobileNets at 32 px and narrow scales, logits within atol = rtol = 1e-4
(XLA and torch sum in different orders); SqueezeNet 1.1 at 48 px and
ShuffleNetV2 x0.25 at 32 px too (``tests/test_torch_vision_zoo_rest.py``
holds the other variants of the last four families). MobileNetV1 at scale 0.25 also
takes a training-mode forward and backward (depthwise convolutions,
batch statistics; it has no dropout) in f64, with every gradient and the
buffers after the step (tolerances in its test).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision.models as J

import paddle_tpu_torch.vision.models as T
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision.models import resnet_flops_per_image
from paddle_tpu_torch.vision.models.mobilenetv2 import _make_divisible
from tests.test_torch_vision_resnet import _tgrads, rel_l2
from tests.test_torch_vision_zoo_rest import numpy_init

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)

# name: (reference constructor, port constructor, keyword arguments,
# input shape)
ZOO = {
    "lenet": (J.LeNet, T.LeNet, {}, (2, 1, 28, 28)),
    "alexnet": (J.alexnet, T.alexnet, dict(num_classes=10), (2, 3, 64, 64)),
    "vgg11": (J.vgg11, T.vgg11, dict(num_classes=10), (2, 3, 32, 32)),
    "mobilenet_v1": (J.mobilenet_v1, T.mobilenet_v1,
                     dict(scale=0.25, num_classes=10), (4, 3, 32, 32)),
    "mobilenet_v2": (J.mobilenet_v2, T.mobilenet_v2,
                     dict(scale=0.35, num_classes=10), (2, 3, 32, 32)),
    "mobilenet_v3_small": (J.mobilenet_v3_small, T.mobilenet_v3_small,
                           dict(scale=0.5, num_classes=10), (2, 3, 32, 32)),
    "squeezenet1_1": (J.squeezenet1_1, T.squeezenet1_1,
                      dict(num_classes=10), (2, 3, 48, 48)),
    "shufflenet_v2_x0_25": (J.shufflenet_v2_x0_25, T.shufflenet_v2_x0_25,
                            dict(num_classes=10), (2, 3, 32, 32)),
}


def _pair(name, seed=0):
    jmake, tmake, kw, shape = ZOO[name]
    paddle_tpu.seed(seed)
    jm = jmake(**kw)
    arrays = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    arrays.update({n: np.asarray(b.numpy()) for n, b in jm.named_buffers()})
    tm = tmake(**kw, device="cpu")
    missing, unexpected = tm.load_state_dict(vision_state_from_jax(arrays,
                                                                   tm))
    assert not missing and not unexpected
    x = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    return jm, tm, x


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_eval_logits_match_reference(name):
    jm, tm, x = _pair(name)
    jm.eval()
    tm.eval()
    want = np.asarray(jm(paddle_tpu.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_mobilenet_v1_train_step_matches_reference_f64():
    """A training-mode step in f64 (both packages' parameters, buffers and
    inputs): like ResNet-50's (``test_torch_vision_resnet50.py``), this
    step's gradients are badly conditioned in f32 at initialisation
    (either package's f32 gradients are a few per cent off an f64 run on
    this batch), so the parity is held in f64: logits atol = rtol = 1e-9,
    the buffers 1e-10, the loss 1e-6 and the gradients below 1e-6
    relative L2 (the cross-entropies compute the softmax in f32)."""
    jm, tm, x = _pair("mobilenet_v1", seed=3)
    for t in list(jm.parameters()) + [b for _, b in jm.named_buffers()]:
        t._value = t._value.astype(np.float64)
    tm = tm.double()
    x = x.astype(np.float64)
    y = np.arange(x.shape[0], dtype=np.int64)[:, None]
    jlog = jm(paddle_tpu.to_tensor(x))
    jloss = paddle_tpu.nn.functional.cross_entropy(jlog,
                                                   paddle_tpu.to_tensor(y))
    jloss.backward()
    tlog = tm(torch.from_numpy(x))
    tloss = TF.cross_entropy(tlog, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tlog.detach().numpy(),
                               np.asarray(jlog.numpy()), atol=1e-9,
                               rtol=1e-9)
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               atol=1e-6, rtol=1e-6)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tg = _tgrads(tm)
    assert set(tg) == set(jg)
    assert tm.features[1].dw[0].weight.shape == (8, 1, 3, 3)   # depthwise
    rel = {n: rel_l2(tg[n], jg[n]) for n in jg}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-6, (worst, rel[worst])
    for n, b in jm.named_buffers():
        np.testing.assert_allclose(tm.get_buffer(n).numpy(),
                                   np.asarray(b.numpy()), err_msg=n,
                                   atol=1e-10, rtol=1e-10)


def test_zoo_parameter_names_and_shapes_are_the_reference():
    """Every family converts key for key at its published widths too (the
    reference's state dict names and shapes, linear weights transposed)."""
    builds = [(J.mobilenet_v3_large, T.mobilenet_v3_large, {}),
              (J.mobilenet_v2, T.mobilenet_v2, {}),
              (J.mobilenet_v1, T.mobilenet_v1, {}),
              (J.shufflenet_v2_x1_0, T.shufflenet_v2_x1_0, {}),
              (J.squeezenet1_0, T.squeezenet1_0, {}),
              (J.googlenet, T.googlenet, {}),
              (J.inception_v3, T.inception_v3, {})]
    for jbuild, tbuild, kw in builds:
        with numpy_init():
            jm = jbuild(**kw)
        tm = tbuild(**kw, device="cpu")
        want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
        want.update({n: tuple(b.shape) for n, b in jm.named_buffers()})
        got = {n: tuple(t.shape) for n, t in tm.state_dict().items()}
        linears = {n for n, m in tm.named_modules()
                   if isinstance(m, torch.nn.Linear)}
        for n, s in got.items():
            if n.rpartition(".")[0] in linears and n.endswith("weight"):
                got[n] = s[::-1]
        assert got == want


def test_make_divisible_and_flops_count():
    assert [_make_divisible(v) for v in (32 * 0.35, 1280, 16 * 0.5, 37)] == \
        [16, 1280, 8, 40]
    # LeNet by hand: conv1 28x28x6 outputs x 9, conv2 10x10x16 x 150, the
    # linear layers 400x120 + 120x84 + 84x10 multiply-adds
    m = T.LeNet(device="cpu")
    want = (28 * 28 * 6 * 9 + 10 * 10 * 16 * 150
            + 400 * 120 + 120 * 84 + 84 * 10)
    assert resnet_flops_per_image(m, 28, in_channels=1) == 2 * want
