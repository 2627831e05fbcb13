"""ShuffleNetV2 in the PyTorch port (paddle_tpu_torch.vision.models)
against the JAX package on the CPU: x0.25's training-mode forward and
backward (depthwise convolutions, batch statistics, the channel shuffle)
in f64, held as ``test_mobilenet_v1_train_step_matches_reference_f64``
holds its step, with the reference's weights and buffers through
``vision_state_from_jax``; and ``shufflenet_flops_per_image`` against a
count by hand.
"""
import numpy as np
import torch

import paddle_tpu
import paddle_tpu.vision.models as J

import paddle_tpu_torch.vision.models as T
from paddle_tpu_torch.nn import functional as TF
from tests.test_torch_vision_resnet import _tgrads, rel_l2
from tests.test_torch_vision_zoo_rest import _pair

torch.set_num_threads(2)


def test_shufflenet_v2_train_step_matches_reference_f64():
    """ShuffleNetV2 x0.25 in training mode in f64 (parameters, buffers and
    inputs in both packages): logits atol = rtol = 1e-9, the loss 1e-6,
    every gradient below 1e-6 relative L2 (the cross-entropies compute the
    softmax in f32) and the batch-norm buffers after the step within
    1e-10. The batch-norm biases of the depthwise blocks (no activation,
    then a 1x1 convolution and a training-mode batch norm, which
    subtracts any per-channel shift) have an exact gradient of 0: on both
    sides their gradients stay below 1e-9 of the largest one."""
    jm, tm = _pair(J.shufflenet_v2_x0_25, T.shufflenet_v2_x0_25,
                   dict(num_classes=10), seed=3)
    for t in list(jm.parameters()) + [b for _, b in jm.named_buffers()]:
        t._value = t._value.astype(np.float64)
    tm = tm.double()
    x = np.random.RandomState(4).randn(4, 3, 32, 32)
    y = np.arange(4, dtype=np.int64)[:, None]
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
    assert tm.stages[1].branch[1][0].weight.shape == (12, 1, 3, 3)  # dw
    scale = max(np.linalg.norm(g) for g in jg.values())
    zero = {n for n in jg if np.linalg.norm(jg[n]) < 1e-9 * scale}
    dw = {f"stages.{i}.{b}.1.bias" for i, unit in enumerate(tm.stages)
          for b in (("left.0", "right.1") if hasattr(unit, "left")
                    else ("branch.1",))}
    assert zero == dw
    assert max(np.linalg.norm(tg[n]) for n in dw) < 1e-9 * scale
    rel = {n: rel_l2(tg[n], jg[n]) for n in jg if n not in dw}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-6, (worst, rel[worst])
    for n, b in jm.named_buffers():
        np.testing.assert_allclose(tm.get_buffer(n).numpy(),
                                   np.asarray(b.numpy()), err_msg=n,
                                   atol=1e-10, rtol=1e-10)


def test_shufflenet_flops_count():
    """``shufflenet_flops_per_image`` counts every convolution (depthwise
    ones at one input channel an output) and the classifier: a
    hand count of x0.25 at 32 px, and about 0.146 G multiply-adds for
    x1.0 at 224."""
    m = T.shufflenet_v2_x1_0(device="cpu")
    macs = T.shufflenet_flops_per_image(m) / 2
    assert 0.14e9 < macs < 0.15e9
    small = T.shufflenet_v2_x0_25(num_classes=10, device="cpu")
    # stem 16x16x24 x 27; the units from their shapes, fc 512 x 10
    want = 16 * 16 * 24 * 27 + 512 * 10
    hw, c_in = 8, 24
    for c_out, reps in zip((24, 48, 96), (4, 8, 4)):
        c = c_out // 2
        hw //= 2
        # left: dw 3x3 / 2, 1x1; right: 1x1 at the input's size, dw / 2, 1x1
        want += hw * hw * (c_in * 9 + c_in * c + c * 9 + c * c) \
            + 4 * hw * hw * c_in * c
        want += (reps - 1) * hw * hw * (c * c + c * 9 + c * c)
        c_in = c_out
    want += hw * hw * 96 * 512
    assert T.shufflenet_flops_per_image(small, 32) == 2 * want
