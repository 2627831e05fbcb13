"""The last four vision families in the PyTorch port
(paddle_tpu_torch.vision.models: SqueezeNet, ShuffleNetV2, GoogLeNet,
InceptionV3) against the JAX package, on the CPU, with the reference's
weights and batch-norm buffers through ``vision_state_from_jax`` (no
missing or unexpected key).

Eval logits of a seeded batch in f32 at atol = rtol = 1e-4 (XLA's and
torch's convolutions sum in different orders): SqueezeNet 1.0 at 64 px,
the ShuffleNetV2 Swish variant at 32 px, GoogLeNet at 224 x 224, batch 1
(its auxiliary heads' fc1 takes 128 x 4 x 4, so 224 is its only size;
all three outputs held), InceptionV3 at 75 px (its smallest legal input).
SqueezeNet 1.1 and ShuffleNetV2 x0.25 are cases of
``tests/test_torch_vision_models.py``'s ``ZOO``;
``tests/test_torch_vision_shufflenet.py`` holds ShuffleNetV2's f64
training step and its flop count.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision.models as J

import paddle_tpu_torch.vision.models as T
from paddle_tpu_torch.models import vision_state_from_jax

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@contextlib.contextmanager
def numpy_init(seed=0):
    """The reference's initialisers drawing from numpy inside the block.

    ``jax.random.uniform`` / ``normal`` compile once per parameter shape
    (about 0.5 s each on this CPU, 40 s for GoogLeNet); the parity tests
    only need the reference's weights to be random and shared, so they
    draw the same distributions from a seeded numpy generator."""
    rng = np.random.RandomState(seed)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    saved = jax.random.uniform, jax.random.normal
    jax.random.uniform, jax.random.normal = uniform, normal
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = saved


def _pair(jmake, tmake, kw, seed=0):
    with numpy_init(seed):
        jm = jmake(**kw)
    arrays = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    arrays.update({n: np.asarray(b.numpy()) for n, b in jm.named_buffers()})
    tm = tmake(**kw, device="cpu")
    missing, unexpected = tm.load_state_dict(vision_state_from_jax(arrays,
                                                                   tm))
    assert not missing and not unexpected
    return jm, tm


CASES = {
    "squeezenet1_0": (J.squeezenet1_0, T.squeezenet1_0,
                      dict(num_classes=10), (2, 3, 64, 64)),
    "shufflenet_v2_swish": (J.shufflenet_v2_swish, T.shufflenet_v2_swish,
                            dict(num_classes=10), (2, 3, 32, 32)),
    "googlenet": (J.googlenet, T.googlenet, dict(num_classes=10),
                  (1, 3, 224, 224)),
    "inception_v3": (J.inception_v3, T.inception_v3, dict(num_classes=10),
                     (1, 3, 75, 75)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_eval_logits_match_reference(name):
    jmake, tmake, kw, shape = CASES[name]
    jm, tm = _pair(jmake, tmake, kw)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = jm(paddle_tpu.to_tensor(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if name == "googlenet":         # (out, aux1, aux2)
        assert len(got) == len(want) == 3
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (shape[0], 10)
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), **TOL)
