"""``nn.Layer`` and ``nn.initializer`` of the port against the JAX
package's, and the regression tests of ROADMAP F4 (state dicts in the
reference's layouts).

- ``Layer``: registration (every parameter, also a plain torch module's,
  is the port's ``Parameter``), traversal, ``create_parameter``, train /
  eval, ``to(dtype)``, forward pre / post hooks and their removal,
  ``ParameterList``, ``state_dict`` / ``set_state_dict`` names and
  missing / unexpected lists, as the reference's.
- Initializers: each draws from an explicit generator (one
  ``paddle.seed`` repeats it) and matches the reference's in
  distribution: bounds exactly, mean and standard deviation within 4 %
  of the scale over 40000 draws (``Constant``, ``Assign``, ``Dirac``
  exactly; ``Orthogonal`` by ``Q Q^T = gain^2 I``).
- F4: a model file written by either package (``paddle.save`` of
  ``state_dict()``) loads into the other's model (``paddle.load`` and
  ``set_state_dict``, no converter, no transpose) and gives the same
  outputs (eval mode, f32, atol = rtol = 1e-4), for every model family
  the port has; ERNIE-tiny's attention projections are square (64 x 64),
  where a transposed load would raise nothing. An optimizer file (Adam's
  moments of those projections) goes across the same way.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.models import ConformerForCTC as JConformer
from paddle_tpu.models import ErnieForMaskedLM as JErnieMLM
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import WhisperForConditionalGeneration as JWhisper
from paddle_tpu.models import conformer_tiny as j_conformer_tiny
from paddle_tpu.models import ernie_tiny as j_ernie_tiny
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.models import whisper_tiny as j_whisper_tiny
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu.vision.models import resnet18 as j_resnet18

import paddle_tpu_torch as T
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import (ConformerForCTC, ErnieForMaskedLM,
                                     LlamaForCausalLM,
                                     WhisperForConditionalGeneration,
                                     conformer_tiny, ernie_tiny, llama_tiny,
                                     whisper_tiny)
from paddle_tpu_torch.vision.models import LeNet, resnet18

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


# -- Layer -----------------------------------------------------------------


def _net(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(3, 4)
            self.w = self.create_parameter([4, 2])
            self.register_buffer("count", P.to_tensor(np.zeros(1)))
            self.register_buffer("scratch", P.to_tensor(np.zeros(1)),
                                 persistable=False)

        def forward(self, x):
            return P.matmul(self.fc(x), self.w)

    return Net()


def test_layer_registration_and_state_dict_as_the_reference():
    jn, tn = _net(J), _net(T)
    want = {n for n, _ in jn.named_parameters()}
    assert {n for n, _ in tn.named_parameters()} == want == {
        "fc.weight", "fc.bias", "w"}
    assert set(tn.state_dict()) == set(jn.state_dict()) == want | {"count"}
    params = tn.parameters()        # Paddle's list, torch's iterator
    assert len(params) == 3 and next(params) is params[0]
    assert all(isinstance(p, T.Parameter) for p in tn.parameters())
    jsd = jn.state_dict()
    assert {k: v.shape for k, v in tn.state_dict().items()} == {
        k: list(v.shape) for k, v in jsd.items()}
    assert tn.fc.weight.shape == [3, 4]                 # Paddle's [in, out]
    assert [type(m).__name__ for m in tn.sublayers()] == ["Linear"]
    missing, unexpected = tn.set_state_dict({"fc.bias": np.ones(4),
                                             "nope": np.ones(1)})
    assert set(missing) == {"fc.weight", "w", "count"}
    assert unexpected == ["nope"]
    jmissing, junexpected = jn.set_state_dict({"fc.bias": np.ones(4),
                                               "nope": np.ones(1)})
    # the reference also lists its non-persistable buffer as missing
    assert set(jmissing) - {"scratch"} == set(missing)
    assert junexpected == unexpected
    np.testing.assert_array_equal(tn.fc.bias.numpy(), np.ones(4))
    with pytest.raises(ValueError):
        tn.set_state_dict({"fc.bias": np.ones(5)})


def test_layer_forward_gives_the_references_outputs():
    jn, tn = _net(J), _net(T)
    tn.set_state_dict({k: v.numpy() for k, v in jn.state_dict().items()})
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    jo = jn(J.to_tensor(x))
    to = tn(T.to_tensor(x))
    assert type(to) is T.Tensor
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    # a port layer hands plain tensors back for plain tensors
    assert type(tn.fc(torch.from_numpy(x))) is torch.Tensor


def test_plain_torch_modules_get_paddle_parameters():
    class Net(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(3, 3)
            self.emb = torch.nn.Embedding(5, 3)

    n = Net()
    assert all(isinstance(p, T.Parameter) for p in n.parameters())
    assert n.proj.weight._paddle_t
    for p in n.parameters():
        p.stop_gradient = True
    assert not any(p.requires_grad for p in n.parameters())
    sd = n.state_dict()
    np.testing.assert_array_equal(sd["proj.weight"].numpy(),
                                  n.proj.weight.detach().numpy().T)
    assert torch.nn.Module.state_dict(n)["proj.weight"].shape == (3, 3)


def test_forward_pre_and_post_hooks_as_the_reference():
    outs = {}
    for P in (J, T):
        layer = P.nn.Linear(2, 2)
        layer.weight.set_value(np.eye(2, dtype=np.float32))
        layer.bias.set_value(np.zeros(2, np.float32))
        seen = []
        pre = layer.register_forward_pre_hook(
            lambda m, inp: seen.append(type(inp[0])) or (inp[0] * 2,))
        post = layer.register_forward_post_hook(
            lambda m, inp, out: seen.append(type(out)) or out + 1)
        x = P.to_tensor(np.array([[1.0, 2.0]], np.float32))
        first = layer(x).numpy()
        pre.remove()
        post.remove()
        assert seen == [P.Tensor, P.Tensor]         # hooks see Tensors
        outs[P] = (first, layer(x).numpy(), len(seen))
    for a, b in zip(outs[J], outs[T]):
        np.testing.assert_array_equal(b, a)


def test_parameter_list_train_eval_and_to():
    ps = [T.create_parameter([2], dtype="float32") for _ in range(3)]
    pl = T.nn.ParameterList(ps)
    assert len(pl) == 3 and pl[1] is ps[1] and list(pl) == ps
    assert [n for n, _ in pl.named_parameters()] == ["0", "1", "2"]
    pl.append(T.create_parameter([1]))
    assert len(pl.parameters()) == 4
    jl = J.nn.ParameterList([J.create_parameter([2], dtype="float32")])
    assert [n for n, _ in jl.named_parameters()] == ["0"]
    net = _net(T)
    net.eval()
    assert not any(m.training for m in net.sublayers(include_self=True))
    net.train()
    net.to(dtype="float64")
    assert net.fc.weight.dtype == torch.float64
    assert isinstance(net.fc.weight, T.Parameter)


def test_freezing_by_stop_gradient():
    net = _net(T)
    for p in net.fc.parameters():
        p.stop_gradient = True
    x = T.to_tensor(np.ones((2, 3), np.float32))
    net(x).sum().backward()
    assert net.fc.weight.grad is None and net.w.grad is not None


# -- initializers ------------------------------------------------------------

I = [("Constant", dict(value=0.3)), ("Uniform", dict(low=-0.2, high=0.5)),
     ("Normal", dict(mean=0.1, std=0.3)),
     ("TruncatedNormal", dict(mean=0.0, std=0.5)),
     ("XavierUniform", {}), ("XavierNormal", {}), ("KaimingUniform", {}),
     ("KaimingNormal", {}), ("XavierUniform", dict(gain=2.0)),
     ("KaimingNormal", dict(nonlinearity="relu"))]


@pytest.mark.parametrize("name,kw", I)
def test_initializer_distribution_as_the_reference(name, kw):
    shape = (200, 200)
    J.seed(1)
    a = np.asarray(getattr(J.nn.initializer, name)(**kw)(shape).numpy())
    T.seed(1)
    b = getattr(T.nn.initializer, name)(**kw)(shape).numpy()
    T.seed(1)
    again = getattr(T.nn.initializer, name)(**kw)(shape).numpy()
    np.testing.assert_array_equal(again, b)
    assert b.shape == a.shape and b.dtype == a.dtype
    scale = max(a.std(), abs(a.mean()), 1e-6)
    assert abs(b.mean() - a.mean()) <= 0.04 * scale
    assert abs(b.std() - a.std()) <= 0.04 * scale
    if "Uniform" in name or name in ("Constant", "TruncatedNormal"):
        # bounded: the bounds themselves (1 % of the scale: the extremes
        # of 40000 draws)
        assert b.min() >= a.min() - 0.01 * scale - 1e-6
        assert b.max() <= a.max() + 0.01 * scale + 1e-6
        assert b.min() <= a.min() + 0.01 * scale + 1e-6


def test_initializers_exact_and_orthogonal_and_in_place():
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    for P in (J, T):
        np.testing.assert_array_equal(
            np.asarray(P.nn.initializer.Assign(v)((2, 3)).numpy()), v)
        d = np.asarray(P.nn.initializer.Dirac()((4, 2, 3, 3)).numpy())
        assert d.sum() == 2 and d[1, 1, 1, 1] == 1
        q = np.asarray(P.nn.initializer.Orthogonal(gain=2.0)((3, 5))
                       .numpy())
        np.testing.assert_allclose(q @ q.T, 4 * np.eye(3), atol=1e-5)
    assert T.nn.initializer.calculate_gain("leaky_relu", 0.1) == \
        J.nn.initializer.calculate_gain("leaky_relu", 0.1)
    w = torch.zeros(4, 4)
    g = torch.Generator().manual_seed(0)
    out = T.nn.initializer.Uniform(0.5, 1.0, generator=g)(w)
    assert out is w and (w >= 0.5).all()


# -- F4: model and optimizer files across the two packages -----------------

ECFG = dict(vocab=97, hidden=64, layers=2, heads=4, inter=128, seq=32)
LCFG = dict(vocab=61, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
            seq=32)


def _ints(seed, shape, high):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _floats(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


FAMILIES = {
    "ernie_square_projections": (
        lambda: JErnieMLM(j_ernie_tiny(**ECFG)),
        lambda: ErnieForMaskedLM(ernie_tiny(**ECFG), device="cpu"),
        lambda: [_ints(1, (2, 12), 97)]),
    "llama": (lambda: JLlama(j_llama_tiny(**LCFG)),
              lambda: LlamaForCausalLM(llama_tiny(**LCFG), device="cpu"),
              lambda: [_ints(2, (2, 10), 61)]),
    "whisper": (lambda: JWhisper(j_whisper_tiny()),
                lambda: WhisperForConditionalGeneration(whisper_tiny(),
                                                        device="cpu"),
                lambda: [_floats(3, (2, 16, 32)), _ints(3, (2, 6), 128)]),
    "conformer_ctc": (lambda: JConformer(j_conformer_tiny()),
                      lambda: ConformerForCTC(conformer_tiny(),
                                              device="cpu"),
                      lambda: [_floats(4, (2, 48, 16))]),
    "lenet": (lambda: JLeNet(), lambda: LeNet(device="cpu"),
              lambda: [_floats(5, (2, 1, 28, 28))]),
    "resnet18": (lambda: j_resnet18(num_classes=10),
                 lambda: resnet18(num_classes=10, device="cpu"),
                 lambda: [_floats(6, (2, 3, 32, 32))]),
}


def _out(m, P, inputs):
    m.eval()
    conv = [P.to_tensor(a) for a in inputs]
    out = m(*conv)
    out = out[0] if isinstance(out, (tuple, list)) else out
    return np.asarray(out.numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_regression_f4_model_files_load_across_packages(family, tmp_path):
    jbuild, tbuild, inputs = FAMILIES[family]
    J.seed(11)
    jm = jbuild()
    T.seed(12)
    tm = tbuild()
    x = inputs()
    assert not np.allclose(_out(jm, J, x), _out(tm, T, x), **TOL)
    # the reference's file into the port: no converter, no transpose
    J.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
    missing, unexpected = tm.set_state_dict(
        T.load(str(tmp_path / "j.pdparams")))
    assert not missing and not unexpected
    np.testing.assert_allclose(_out(tm, T, x), _out(jm, J, x), **TOL)
    # the port's file (other weights) into the reference
    T.seed(13)
    tm2 = tbuild()
    T.save(tm2.state_dict(), str(tmp_path / "t.pdparams"))
    jm.set_state_dict(J.load(str(tmp_path / "t.pdparams")))
    np.testing.assert_allclose(_out(jm, J, x), _out(tm2, T, x), **TOL)
    assert {n: list(a.shape) for n, a in jm.state_dict().items()} == {
        n: list(b.shape) for n, b in tm2.state_dict().items()}


def test_regression_f4_square_projection_would_load_silently_transposed():
    """ERNIE-tiny's q / k / v / out projections are 64 x 64: loading the
    reference's [in, out] weight into torch's [out, in] storage as it is
    raises nothing, and only the outputs show it."""
    J.seed(11)
    jm = JErnieMLM(j_ernie_tiny(**ECFG))
    tm = ErnieForMaskedLM(ernie_tiny(**ECFG), device="cpu")
    name = "ernie.encoder.layers.0.self_attn.q_proj.weight"
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert sd[name].shape == (64, 64)
    x = [_ints(1, (2, 12), 97)]
    tm.set_state_dict(sd)                           # Paddle's layout
    np.testing.assert_allclose(_out(tm, T, x), _out(jm, J, x), **TOL)
    np.testing.assert_array_equal(tm.state_dict()[name].numpy(), sd[name])
    with torch.no_grad():                           # as torch's would
        tm.ernie.encoder.layers[0].self_attn.q_proj.weight.copy_(
            torch.from_numpy(sd[name]))
    assert not np.allclose(_out(tm, T, x), _out(jm, J, x), **TOL)


def test_regression_f4_state_dict_round_trips_however_it_is_called():
    """``state_dict(keep_vars=True)`` (torch's snapshot idiom) and a
    ``destination`` give Paddle's layout as ``state_dict()`` does, so
    ``load_state_dict`` of either leaves ERNIE-tiny's square projections
    as they were (a transposed reload would raise nothing)."""
    J.seed(11)
    jm = JErnieMLM(j_ernie_tiny(**ECFG))
    tm = ErnieForMaskedLM(ernie_tiny(**ECFG), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    name = "ernie.encoder.layers.0.self_attn.q_proj.weight"
    x = [_ints(1, (2, 12), 97)]
    want = _out(jm, J, x)
    paddle_sd = tm.state_dict()
    for sd in (tm.state_dict(keep_vars=True), tm.state_dict({}),
               tm.state_dict(destination={})):
        assert list(sd) == list(paddle_sd)
        np.testing.assert_array_equal(sd[name].numpy(),
                                      paddle_sd[name].numpy())
        snapshot = {k: v.clone() for k, v in sd.items()}
        tm.load_state_dict(snapshot)
        np.testing.assert_allclose(_out(tm, T, x), want, **TOL)
    assert torch.nn.Module.state_dict(tm)[name].shape == (64, 64)


def test_regression_f4_optimizer_files_load_across_packages(tmp_path):
    """One Adam step on the same weights and the same loss in both
    packages; the port's optimizer file holds the square projections'
    moments in Paddle's [in, out], equal to the reference's, and a second
    step after loading either package's file into the other matches."""
    J.seed(11)
    jm = JErnieMLM(j_ernie_tiny(**ECFG))
    tm = ErnieForMaskedLM(ernie_tiny(**ECFG), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    jo = J.optimizer.Adam(parameters=jm.parameters(), learning_rate=1e-2)
    to = T.optimizer.Adam(parameters=tm.parameters(), learning_rate=1e-2)
    ids = _ints(1, (2, 12), 97)

    def jstep():
        loss = J.nn.functional.cross_entropy(
            jm(J.to_tensor(ids)).reshape([-1, 97]),
            J.to_tensor(ids.reshape(-1)))
        loss.backward()
        jo.step()
        jo.clear_grad()

    def tstep(m, o):
        loss = T.nn.functional.cross_entropy(
            m(T.to_tensor(ids)).reshape([-1, 97]),
            T.to_tensor(ids.reshape(-1)))
        loss.backward()
        o.step()
        o.clear_grad()

    jstep()
    tstep(tm, to)
    js, ts = jo.state_dict(), to.state_dict()
    names = [n for n, _ in jm.named_parameters()]
    k = names.index("ernie.encoder.layers.0.self_attn.q_proj.weight")
    for st in ("moment1", "moment2"):
        np.testing.assert_allclose(ts[f"param{k}.{st}"].numpy(),
                                   js[f"param{k}.{st}"].numpy(),
                                   atol=1e-6, rtol=1e-3)
    # the port's files into the reference, then one more step each
    T.save(ts, str(tmp_path / "t.pdopt"))
    T.save(tm.state_dict(), str(tmp_path / "t.pdparams"))
    jm.set_state_dict(J.load(str(tmp_path / "t.pdparams")))
    jo.set_state_dict(J.load(str(tmp_path / "t.pdopt")))
    # and the reference's into a fresh port model
    J.save(jo.state_dict(), str(tmp_path / "j.pdopt"))
    J.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
    tm2 = ErnieForMaskedLM(ernie_tiny(**ECFG), device="cpu")
    tm2.set_state_dict(T.load(str(tmp_path / "j.pdparams")))
    to2 = T.optimizer.Adam(parameters=tm2.parameters(), learning_rate=1e-2)
    to2.set_state_dict(T.load(str(tmp_path / "j.pdopt")))
    jstep()
    tstep(tm, to)
    tstep(tm2, to2)
    want = {n: a.numpy() for n, a in jm.state_dict().items()}
    for m in (tm, tm2):
        for n, b in m.state_dict().items():
            if n.endswith("k_proj.bias"):
                # its exact gradient is 0 (the softmax cancels it): Adam
                # scales either package's rounding noise up to lr steps
                continue
            np.testing.assert_allclose(b.numpy(), want[n], atol=1e-4,
                                       rtol=1e-3, err_msg=n)
