"""``paddle.inference`` in the port (Config, create_predictor, the handle
workflow, ``clone``, ``share_external_data``) against the JAX package, on
the CPU.

Both packages save the same weights with their ``jit.save`` and serve them
through their own predictors; the same numpy inputs give the same outputs
(f32: 1e-5 for MLPs, 1e-4 relative for ``ernie_tiny()``). The port
compiles the loaded program with the ``aot_eager`` backend here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
from paddle_tpu import inference as rinf
from paddle_tpu import jit as rjit
from paddle_tpu.models import ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models import ernie_tiny as j_ernie_tiny

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                     ernie_state_from_jax, ernie_tiny)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    prev = tdevice._state["device"]
    paddle.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _saved_linear_pair(tmp_path, seed=0, shape=(2, 4)):
    """The JAX package's Linear(4, 3) and the port's with its weights, each
    saved with its own jit.save; returns both prefixes and the JAX layer."""
    paddle_tpu.seed(seed)
    jl = jnn.Linear(4, 3)
    tl = paddle.nn.Linear(4, 3)
    tl.set_state_dict({k: np.asarray(v._value)
                       for k, v in jl.state_dict().items()})
    rprefix, tprefix = str(tmp_path / "ref"), str(tmp_path / "port")
    rjit.save(jl, rprefix, input_spec=[(list(shape), "float32")])
    jit.save(tl, tprefix, input_spec=[([None, 4], "float32")])
    return rprefix, tprefix, jl


def _cpu_config(prefix, **kw):
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    return cfg


def test_handle_workflow_and_direct_form_match_reference(tmp_path):
    rprefix, tprefix, jl = _saved_linear_pair(tmp_path)
    x = np.random.RandomState(2).standard_normal((2, 4)).astype(np.float32)
    rp = rinf.create_predictor(rinf.Config(rprefix + ".pdmodel"))
    (want,) = rp.run([x])
    p = inference.create_predictor(_cpu_config(tprefix))
    names = p.get_input_names()
    assert names == ["input_0"]
    p.get_input_handle(names[0]).copy_from_cpu(x)
    p.run()
    out = p.get_output_handle(p.get_output_names()[0])
    assert isinstance(out._value, torch.Tensor)
    np.testing.assert_allclose(out.copy_to_cpu(), want, **TOL)
    (got,) = p.run([x])
    np.testing.assert_allclose(got, want, **TOL)
    # one compiled program per input signature
    p.run([np.ones((5, 4), np.float32)])
    assert len(p._served.compiled) == 2


def test_clone_shares_program_and_serves_independently(tmp_path):
    _, tprefix, jl = _saved_linear_pair(tmp_path, 1)
    p1 = inference.create_predictor(_cpu_config(tprefix))
    p2 = p1.clone()
    assert p2._layer is p1._layer and p2._served is p1._served
    x1 = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    x2 = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    p1.get_input_handle("input_0").copy_from_cpu(x1)
    p2.get_input_handle("input_0").copy_from_cpu(x2)
    p1.run()
    p2.run()
    for p, x in ((p1, x1), (p2, x2)):
        np.testing.assert_allclose(
            p.get_output_handle("output_0").copy_to_cpu(),
            jl(paddle_tpu.to_tensor(x)).numpy(), **TOL)


def test_share_external_data_adopts_without_a_copy(tmp_path):
    _, tprefix, jl = _saved_linear_pair(tmp_path, 2)
    p = inference.create_predictor(_cpu_config(tprefix))
    t = torch.ones(2, 4)
    h = p.get_input_handle("input_0")
    h.share_external_data(t)
    assert h._value.data_ptr() == t.data_ptr()
    p.run()
    host = p.get_output_handle("output_0").copy_to_cpu()
    assert isinstance(host, np.ndarray) and host.shape == (2, 3)
    np.testing.assert_allclose(
        host, jl(paddle_tpu.ones([2, 4])).numpy(), **TOL)


def test_ir_optim_off_runs_the_exported_graph(tmp_path):
    _, tprefix, jl = _saved_linear_pair(tmp_path, 3)
    cfg = _cpu_config(tprefix)
    cfg.switch_ir_optim(False)
    p = inference.create_predictor(cfg)
    x = np.ones((3, 4), np.float32)
    (got,) = p.run([x])
    assert not p._served.compiled
    np.testing.assert_allclose(got, jl(paddle_tpu.to_tensor(x)).numpy(),
                               **TOL)


def test_missing_files_and_unfilled_handles_raise(tmp_path):
    cfg = inference.Config(str(tmp_path / "nope.pdmodel"))
    cfg.disable_gpu()
    with pytest.raises(FileNotFoundError, match="nope.pdmodel"):
        inference.create_predictor(cfg)
    empty = inference.Config()
    empty.disable_gpu()
    with pytest.raises(ValueError, match="no model to load"):
        inference.create_predictor(empty)
    _, tprefix, _ = _saved_linear_pair(tmp_path, 4)
    p = inference.create_predictor(_cpu_config(tprefix))
    with pytest.raises(ValueError, match="not filled"):
        p.run()


def test_ernie_tiny_served_by_both_packages(tmp_path):
    cfg = dict(vocab=97, hidden=32, layers=2, heads=4, inter=64, seq=32)
    paddle_tpu.seed(0)
    jm = JErnieCls(j_ernie_tiny(**cfg), num_classes=2)
    jm.eval()
    tm = ErnieForSequenceClassification(ernie_tiny(**cfg), device="cpu")
    tm.set_state_dict(ernie_state_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}, tm))
    ids = np.random.RandomState(0).randint(0, 97, (2, 16))
    rprefix, tprefix = str(tmp_path / "ref"), str(tmp_path / "port")
    rjit.save(jm, rprefix, input_spec=[([2, 16], "int64")])
    jit.save(tm, tprefix, input_spec=[([None, None], "int64")])
    (want,) = rinf.create_predictor(rinf.Config(rprefix + ".pdmodel")).run(
        [ids])
    p = inference.create_predictor(_cpu_config(tprefix))
    (got,) = p.run([ids])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    # the same artifact at another batch and length
    ids2 = np.random.RandomState(1).randint(0, 97, (3, 9))
    (got2,) = p.clone().run([ids2])
    want2 = jm(paddle_tpu.to_tensor(ids2)).numpy()
    assert np.linalg.norm(got2 - want2) / np.linalg.norm(want2) <= 1e-4


def test_predictor_over_a_static_inference_model(tmp_path):
    main = paddle.static.Program()
    scope = paddle.static.Scope()
    with paddle.static.scope_guard(scope):
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 3], "float32")
            y = paddle.static.nn.fc(x, 2, name="fc")
        exe = paddle.static.Executor()
        prefix = str(tmp_path / "static")
        paddle.static.save_inference_model(prefix, [x], [y], exe)
        f = np.random.RandomState(0).rand(4, 3).astype(np.float32)
        (want,) = exe.run(main, feed={"x": f}, fetch_list=[y])
    (got,) = inference.create_predictor(_cpu_config(prefix)).run([f])
    np.testing.assert_allclose(got, want, **TOL)
