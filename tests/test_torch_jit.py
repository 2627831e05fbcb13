"""``jit.to_static`` / ``jit.save`` / ``jit.load``, the flags, the op-version
sidecar and the registered kernel ops of the port (paddle_tpu_torch)
against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages' ``to_static``
and ``jit.save`` / ``jit.load``: f32 outputs agree to 1e-5 (MLPs) and to
1e-4 relative (``ernie_tiny()``, weights carried by
``ernie_state_from_jax``). The port compiles with the ``aot_eager``
backend here (``jit.DEFAULT_BACKEND``; inductor on the card). The
registered ops pass ``torch.library.opcheck`` on their CPU implementations;
eager calls of the kernels' Functions never dispatch through them; RMSNorm
and flash dropout compile (F6 repaired).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import zipfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu import jit as rjit
from paddle_tpu.models import ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models import ernie_tiny as j_ernie_tiny

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit, kernels
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.framework import op_version
from paddle_tpu_torch.kernels import library
from paddle_tpu_torch.kernels.flash_attention import FlashAttentionFunction
from paddle_tpu_torch.kernels.layernorm import LayerNormFunction
from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                     ernie_state_from_jax, ernie_tiny)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=97, hidden=32, layers=2, heads=4, inter=64, seq=32)


@pytest.fixture(autouse=True)
def _cpu_aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    prev = tdevice._state["device"]
    paddle.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _mlp_pair(seed=0):
    """A JAX MLP and the port's, with the reference's weights."""
    paddle_tpu.seed(seed)

    class JMLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(8, 16)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(jnn.functional.relu(self.fc1(x)))

    jm = JMLP()
    tm = MLP()
    tm.set_state_dict({k: np.asarray(v._value)
                       for k, v in jm.state_dict().items()})
    return jm, tm


class MLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(8, 16)
        self.fc2 = paddle.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _ernie_pair(seed=0):
    paddle_tpu.seed(seed)
    jm = JErnieCls(j_ernie_tiny(**CFG), num_classes=2)
    jm.eval()
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = ErnieForSequenceClassification(ernie_tiny(**CFG), device="cpu")
    tm.set_state_dict(ernie_state_from_jax(params, tm))
    tm.eval()
    return jm, tm


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], shape)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# to_static
# ---------------------------------------------------------------------------

def test_to_static_mlp_matches_reference_and_caches_per_signature():
    jm, tm = _mlp_pair()
    x = np.random.RandomState(1).rand(3, 8).astype(np.float32)
    want = rjit.to_static(jm)(paddle_tpu.to_tensor(x)).numpy()
    st = jit.to_static(tm)
    got = st(paddle.to_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st(paddle.to_tensor(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    assert len(st.forward_static.concrete_programs) == 1
    x5 = np.random.RandomState(2).rand(5, 8).astype(np.float32)
    assert st(paddle.to_tensor(x5)).shape == [5, 4]
    assert len(st.forward_static.concrete_programs) == 2


def test_to_static_outputs_carry_no_gradient_in_both_packages():
    """R14: the reference's to_static outputs have stop_gradient True (its
    Tensor._wrap default); the port's do too."""
    jm, tm = _mlp_pair()
    x = np.ones((2, 8), np.float32)
    jout = rjit.to_static(jm)(paddle_tpu.to_tensor(x, stop_gradient=False))
    tout = jit.to_static(tm)(paddle.to_tensor(x, stop_gradient=False))
    assert jout.stop_gradient and tout.stop_gradient
    assert isinstance(tout, paddle.Tensor) and not tout.requires_grad


def test_to_static_sees_in_place_and_replaced_weights():
    _, tm = _mlp_pair(5)
    st = jit.to_static(tm)
    x = paddle.to_tensor(np.ones((2, 8), np.float32))
    st(x)
    state = {k: np.zeros_like(v.numpy()) for k, v in tm.state_dict().items()}
    tm.set_state_dict(state)                     # in place
    np.testing.assert_array_equal(st(x).numpy(), np.zeros((2, 4)))
    tm.fc2.bias = torch.nn.Parameter(torch.ones(4))  # a new object
    np.testing.assert_array_equal(st(x).numpy(), np.ones((2, 4)))
    assert len(st.forward_static.concrete_programs) == 1


def test_to_static_ernie_tiny_matches_reference():
    jm, tm = _ernie_pair()
    ids = _ids((2, 16))
    want = rjit.to_static(jm)(paddle_tpu.to_tensor(ids)).numpy()
    got = jit.to_static(tm)(torch.as_tensor(ids))
    assert _rel(got.numpy(), want) <= 1e-4


def test_to_static_function_and_concrete_programs():
    @paddle_tpu.jit.to_static
    def rf(x):
        return paddle_tpu.exp(x) + 1.0

    @jit.to_static
    def tf(x):
        return paddle.exp(x) + 1.0

    x = np.array([0.0, 1.0], np.float32)
    np.testing.assert_allclose(tf(torch.as_tensor(x)).numpy(),
                               rf(paddle_tpu.to_tensor(x)).numpy(),
                               rtol=1e-6)
    assert len(tf.concrete_programs) == len(rf.concrete_programs) == 1
    tf(torch.ones(3))
    assert len(tf.concrete_programs) == 2
    assert tf.rollback() is tf._target


def test_tensor_kwargs_key_by_signature_not_value():
    @jit.to_static
    def f(x, scale=None):
        return x * scale

    for v in (2.0, 3.0):
        out = f(torch.ones(2), scale=torch.tensor(v))
        np.testing.assert_allclose(out.numpy(), [v, v])
    assert len(f.concrete_programs) == 1


def test_functional_state_and_call():
    from paddle_tpu_torch.nn.layer import functional_call, functional_state

    _, tm = _mlp_pair(6)
    params, buffers = functional_state(tm)
    assert all(type(v) is torch.Tensor and not v.requires_grad
               for v in params.values())
    x = torch.ones(2, 8)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    out, _ = functional_call(tm, zeros, buffers, x, training=False)
    np.testing.assert_array_equal(out.detach().numpy(), np.zeros((2, 4)))
    assert tm.training                  # restored
    with torch.no_grad():
        torch.testing.assert_close(
            functional_call(tm, params, buffers, x)[0], tm(x))


def test_more_signatures_than_the_recompile_limit_all_compile(monkeypatch):
    """Dynamo's recompile limit is per code object; each key compiles its
    own copy, so no signature past the limit runs eagerly."""
    compiles = []

    def counting(gm, example_inputs):
        compiles.append(len(example_inputs))
        return gm.forward

    monkeypatch.setattr(jit, "DEFAULT_BACKEND", counting)
    monkeypatch.setattr(torch._dynamo.config, "cache_size_limit", 2)

    @jit.to_static
    def f(x):
        return x * 2 + 1

    n = 5
    for k in range(1, n + 1):
        out = f(torch.ones(k))
        np.testing.assert_allclose(out.numpy(), np.full(k, 3.0))
    assert len(compiles) == n
    assert len(f.concrete_programs) == n


def test_to_static_rms_norm_equals_eager():
    """Every kernel is a registered op (F6 repaired): RMSNorm compiles and
    its program gives the eager bits on the CPU."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(4, 16, generator=g), torch.randn(16, generator=g)

    @jit.to_static
    def f(x, w):
        return paddle.nn.functional.rms_norm(x, w)

    torch.testing.assert_close(f(x, w), paddle.nn.functional.rms_norm(x, w),
                               atol=0, rtol=0)
    assert len(f.concrete_programs) == 1


def test_flash_dropout_compiles():
    """Flash attention with dropout compiles: the program draws its seed
    each call (two calls drop different masks), and an explicit seed gives
    the eager output bit for bit."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    q = torch.randn(1, 16, 2, 8, generator=torch.Generator().manual_seed(4))

    @jit.to_static
    def f(q):
        return scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                            training=True)

    assert not torch.equal(f(q), f(q))

    @jit.to_static
    def seeded(q):
        return scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                            training=True, seed=77)

    torch.testing.assert_close(
        seeded(q), scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                                training=True, seed=77),
        atol=0, rtol=0)


def test_enable_to_static_off_runs_python():
    calls = []

    @jit.to_static
    def f(x):
        calls.append(1)
        return x + 1

    jit.enable_to_static(False)
    try:
        f(torch.ones(2))
        f(torch.ones(2))
    finally:
        jit.enable_to_static(True)
    assert len(calls) == 2 and not f.concrete_programs


# ---------------------------------------------------------------------------
# registered ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["layernorm", "flash", "flash_mask",
                                  "flash_causal"])
def test_registered_ops_pass_opcheck(case):
    g = torch.Generator().manual_seed(0)
    if case == "layernorm":
        args = (torch.randn(6, 16, generator=g), torch.randn(16, generator=g),
                torch.randn(16, generator=g), 1e-5)
        torch.library.opcheck(library.layernorm_fwd, args)
        return
    q = torch.randn(2, 5, 3, 8, generator=g)
    k, v = torch.randn_like(q), torch.randn_like(q)
    mask = None
    if case == "flash_mask":
        mask = (torch.rand(2, 3, 5, 5, generator=g) > 0.3)
    torch.library.opcheck(library.flash_attention_fwd,
                          (q, k, v, mask, case == "flash_causal", None, 0.0,
                           None))


def test_registered_ops_match_the_plain_versions():
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_plain
    from paddle_tpu_torch.kernels.layernorm import layer_norm_plain

    g = torch.Generator().manual_seed(1)
    x, w, b = (torch.randn(4, 8, generator=g), torch.randn(8, generator=g),
               torch.randn(8, generator=g))
    for got, want in zip(torch.ops.paddle_tpu_torch.layernorm_fwd(x, w, b,
                                                                  1e-5),
                         layer_norm_plain(x, w, b, 1e-5)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    q = torch.randn(1, 4, 2, 8, generator=g)
    for got, want in zip(torch.ops.paddle_tpu_torch.flash_attention_fwd(
            q, q, q, None, True, None, 0.0, None),
            flash_attention_plain(q, q, q, causal=True)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_eager_functions_never_dispatch_through_the_registered_ops():
    x = torch.randn(4, 8)
    q = torch.randn(1, 4, 2, 8)
    with _OpLog() as log:
        LayerNormFunction.apply(x, torch.ones(8), torch.zeros(8), 1e-5)
        FlashAttentionFunction.apply(q, q, q, False, None, 0.0, 0, None)
    assert log.names and not any("paddle_tpu_torch" in n for n in log.names)


def test_compiled_program_calls_the_registered_ops(monkeypatch):
    graphs = []

    def capture(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    monkeypatch.setattr(jit, "DEFAULT_BACKEND", capture)
    _, tm = _ernie_pair()
    jit.to_static(tm)(torch.as_tensor(_ids((2, 8))))
    targets = [str(n.target) for n in graphs[0].graph.nodes]
    # ernie_tiny: 1 + 2 * 2 LayerNorms, 2 attention layers
    assert sum("layernorm_fwd" in t for t in targets) == 5
    assert sum("flash_attention_fwd" in t for t in targets) == 2


# ---------------------------------------------------------------------------
# jit.save / jit.load
# ---------------------------------------------------------------------------

def test_save_load_dynamic_batch_matches_reference(tmp_path):
    jm, tm = _mlp_pair(3)
    prefix = str(tmp_path / "mlp")
    jit.save(tm, prefix, input_spec=[([None, 8], "float32")])
    for name in (".pdmodel", ".pdmodel.txt", ".pdiparams", ".pdversion"):
        assert os.path.exists(prefix + name)
    loaded = jit.load(prefix, device="cpu")
    assert "paddle_tpu_torch" in loaded.program() or "linear" in \
        loaded.program()
    for n in (3, 7):
        x = np.random.RandomState(n).standard_normal((n, 8)).astype(
            np.float32)
        want = jm(paddle_tpu.to_tensor(x)).numpy()
        got = loaded(paddle.to_tensor(x))
        assert got.stop_gradient
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_save_load_ernie_tiny_any_batch_and_length(tmp_path):
    jm, tm = _ernie_pair()
    prefix = str(tmp_path / "ernie")
    jit.save(tm, prefix, input_spec=[([None, None], "int64")])
    # the program holds no tensor data (no weights, no example inputs):
    # the weights are .pdiparams'
    with zipfile.ZipFile(prefix + ".pdmodel") as z:
        data = [z.getinfo(n).file_size for n in z.namelist()
                if "/data/" in n]
    assert data and sum(data) < 1024
    loaded = jit.load(prefix, device="cpu")
    for shape in ((2, 16), (3, 9)):
        ids = _ids(shape, shape[1])
        want = jm(paddle_tpu.to_tensor(ids)).numpy()
        assert _rel(loaded(torch.as_tensor(ids)).numpy(), want) <= 1e-4


def test_load_in_a_fresh_process_without_the_model(tmp_path):
    _, tm = _ernie_pair(1)
    prefix = str(tmp_path / "ernie")
    jit.save(tm, prefix, input_spec=[([None, None], "int64")])
    ids = _ids((2, 12), 5)
    np.save(str(tmp_path / "ids.npy"), ids)
    with torch.no_grad():
        want = tm(torch.as_tensor(ids)).numpy()
    child = textwrap.dedent(f"""
        import numpy as np, torch
        import paddle_tpu_torch as paddle
        layer = paddle.jit.load({prefix!r}, device="cpu")
        out = layer(torch.as_tensor(np.load({str(tmp_path / 'ids.npy')!r})))
        np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
        import sys
        assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
    """)
    subprocess.run([sys.executable, "-c", child], check=True, cwd=REPO,
                   timeout=300)
    np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")), want,
                               atol=1e-5, rtol=1e-5)


def test_pdiparams_cross_load_both_ways(tmp_path):
    jm, tm = _mlp_pair(4)
    x = np.random.RandomState(0).rand(2, 8).astype(np.float32)
    want = jm(paddle_tpu.to_tensor(x)).numpy()
    # the JAX package's files into the port's layer
    rprefix = str(tmp_path / "ref")
    rjit.save(jm, rprefix, input_spec=[([None, 8], "float32")])
    layer = jit.load(rprefix, layer_cls=MLP)
    np.testing.assert_allclose(layer(paddle.to_tensor(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    # the port's files into the JAX package's layer
    tprefix = str(tmp_path / "port")
    jit.save(tm, tprefix, input_spec=[([None, 8], "float32")])
    blob = pickle.load(open(tprefix + ".pdiparams", "rb"))
    assert set(blob) >= {"params", "buffers", "in_shapes"}
    assert all(isinstance(v, np.ndarray) for v in blob["params"].values())
    back = rjit.load(tprefix, layer_cls=type(jm))
    np.testing.assert_allclose(back(paddle_tpu.to_tensor(x)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_ernie_pdiparams_cross_load_from_the_reference(tmp_path):
    jm, _ = _ernie_pair(2)
    rprefix = str(tmp_path / "ref")
    rjit.save(jm, rprefix, input_spec=[([2, 16], "int64")])
    layer = jit.load(rprefix, layer_cls=ErnieForSequenceClassification(
        ernie_tiny(**CFG), device="cpu"))
    ids = _ids((2, 16), 3)
    want = jm(paddle_tpu.to_tensor(ids)).numpy()
    with torch.no_grad():
        assert _rel(layer(torch.as_tensor(ids)).numpy(), want) <= 1e-4


def test_jax_artifact_without_layer_cls_is_refused(tmp_path):
    jm, _ = _mlp_pair()
    prefix = str(tmp_path / "ref")
    rjit.save(jm, prefix, input_spec=[([2, 8], "float32")])
    with pytest.raises(RuntimeError, match="StableHLO"):
        jit.load(prefix, device="cpu")


def test_pdversion_sidecar_and_newer_op_versions_refused(tmp_path):
    net = paddle.nn.Linear(4, 2)
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[([2, 4], "float32")])
    meta = json.load(open(prefix + ".pdversion"))
    assert meta["ir"] == op_version.IR == "torch.export"
    assert meta["op_versions"]["flash_attn_unpadded"] == 2
    assert jit.load(prefix, device="cpu") is not None
    meta["op_versions"]["flash_attn_unpadded"] = 99
    json.dump(meta, open(prefix + ".pdversion", "w"))
    with pytest.raises(RuntimeError, match="newer op semantics"):
        jit.load(prefix, device="cpu")
    os.remove(prefix + ".pdversion")
    assert jit.load(prefix, device="cpu") is not None
    with pytest.raises(ValueError, match="must exceed"):
        op_version.register_op_version("dropout", 1, "regression")


class _Marker:
    """Unpickles as a call of ``open(path, "w")``: a file that appears
    shows the pickle's global ran."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("reader", ["jit.load", "static.load",
                                    "load_inference_model"])
def test_params_pickles_refuse_other_globals(tmp_path, reader):
    prefix = str(tmp_path / "m")
    marker = str(tmp_path / "ran")
    blob = {"params": {"w": _Marker(marker)}, "buffers": {},
            "in_shapes": [], "feed_names": [], "fetch_names": []}
    suffix = ".pdparams" if reader == "static.load" else ".pdiparams"
    with open(prefix + suffix, "wb") as f:
        pickle.dump(blob, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing to unpickle .*open"):
        if reader == "jit.load":
            jit.load(prefix, layer_cls=paddle.nn.Linear(2, 2))
        elif reader == "static.load":
            paddle.static.load(paddle.static.Program(), prefix)
        else:
            paddle.static.load_inference_model(prefix, None, device="cpu")
    assert not os.path.exists(marker)


def test_params_pickles_read_numpy_and_bf16_leaves(tmp_path):
    from paddle_tpu_torch.framework.io import load_pickle

    w = torch.arange(4, dtype=torch.float32).reshape(2, 2)
    path = str(tmp_path / "p.pdiparams")
    with open(path, "wb") as f:
        pickle.dump({"params": {"f32": jit._host_array(w),
                                "bf16": jit._host_array(w.bfloat16())}}, f)
    with open(path, "rb") as f:
        got = load_pickle(f)["params"]
    np.testing.assert_array_equal(got["f32"], w.numpy())
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(), w.numpy())


def test_save_without_input_spec_raises():
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(paddle.nn.Linear(2, 2), "unused")


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_flags_registry_env_and_unknown_names(monkeypatch):
    assert paddle.get_flags("FLAGS_dy2static_eager_fallback") == \
        paddle_tpu.get_flags("FLAGS_dy2static_eager_fallback") == {
            "FLAGS_dy2static_eager_fallback": False}
    for name in ("FLAGS_use_pallas", "FLAGS_locksan", "FLAGS_no_such"):
        with pytest.raises(ValueError, match="unknown flag"):
            paddle.set_flags({name: True})
    prev = torch.backends.cudnn.deterministic
    try:
        paddle.set_flags({"FLAGS_cudnn_deterministic": "1"})
        assert torch.backends.cudnn.deterministic is True
        assert paddle.get_flags(["FLAGS_cudnn_deterministic"]) == {
            "FLAGS_cudnn_deterministic": True}
    finally:
        paddle.set_flags({"FLAGS_cudnn_deterministic": False})
        torch.backends.cudnn.deterministic = prev
    from paddle_tpu_torch.framework import flags

    monkeypatch.setenv("FLAGS_test_env_flag", "true")
    assert flags.register_flag("FLAGS_test_env_flag", False).value is True
    flags._REGISTRY.pop("FLAGS_test_env_flag")
