"""``paddle.static`` in the port (Program, Executor, Scope, ``static.nn``,
``gradients``, ``save`` / ``load``, ``save_inference_model``) against the
JAX package, on the CPU.

Each program is built in both packages; the JAX program's parameter values
are written into the port's Scope (parameter by parameter, in creation
order), and the
same numpy feeds go through both Executors: f32 fetches agree to 1e-5
(``ernie_tiny()`` to 1e-4 relative). The port compiles with the
``aot_eager`` backend here.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                     ernie_state_from_jax, ernie_tiny)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    prev = tdevice._state["device"]
    paddle.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _both(build, feeds_list):
    """Build ``build(P)`` -> fetch list in a fresh Program and Scope of each
    package, carry the JAX Scope's parameters into the port's, and run
    every feed through both Executors; returns the per-feed pairs and the
    port's Executor."""
    scopes = {}
    for P in (paddle_tpu, paddle):
        scope = P.static.Scope()
        with P.static.scope_guard(scope):
            main = P.static.Program()
            with P.static.program_guard(main):
                fetches = build(P)
        scopes[P] = (scope, main, fetches)
    jscope, jmain, _ = scopes[paddle_tpu]
    tscope, tmain, _ = scopes[paddle]
    # by creation order: default names count per package
    for jname, tname in zip(jmain._params, tmain._params):
        tscope.var(tname).set(np.asarray(jscope.find_var(jname)._value))
    exe = paddle.static.Executor()
    results = []
    for feed in feeds_list:
        pair = []
        for P, e in ((paddle_tpu, paddle_tpu.static.Executor()),
                     (paddle, exe)):
            scope, main, fetches = scopes[P]
            with P.static.scope_guard(scope):
                pair.append(e.run(main, feed=feed, fetch_list=fetches))
        results.append(pair)
    return results, exe, scopes


def _assert_pairs(results, **tol):
    for want, got in results:
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, **(tol or TOL))


def test_program_executor_matches_reference():
    def build(P):
        x = P.static.data("x", [None, 3], "float32")
        w = P.to_tensor(np.ones((3, 2), np.float32))
        y = P.matmul(x, w)
        return [P.nn.functional.relu(y - 1.0)]

    f = np.array([[1.0, 2.0, 3.0]], np.float32)
    results, exe, _ = _both(build, [{"x": f}, {"x": f * 0}])
    _assert_pairs(results)
    np.testing.assert_allclose(results[0][1][0], [[5.0, 5.0]])


def test_torch_calls_on_placeholders_replay_the_feeds():
    # each fetch is computed from the fed value, never the build-time zeros
    def build(P):
        x = P.static.data("x", [2, 3], "float32")
        w = P.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))
        return [x.clone() * 2, x.t(), P.matmul(x, w)]

    f = np.arange(6, dtype=np.float32).reshape(2, 3)
    results, exe, _ = _both(build, [{"x": f}, {"x": f * -3 + 1}])
    _assert_pairs(results)
    np.testing.assert_allclose(results[1][1][0], (f * -3 + 1) * 2)
    assert exe._trace_count == 1


def test_capture_sees_torch_functions_methods_and_in_place_writes():
    # the JAX package's capture records neither __setitem__ nor detach (its
    # replay returns the feed unwritten / the build-time value), so these
    # are held against numpy
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [2, 3], "float32")
        w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        y = x * 1.0
        row = y[1]                       # taken before the write below
        y[0] = 5.0
        z = x + 0
        z.add_(10)
        fetches = {
            "T": (x.T, lambda f: f.T),
            "torch.matmul": (torch.matmul(x, w), lambda f: f @ w.numpy()),
            "relu.permute.float": (torch.relu(x - 1).permute(1, 0).float(),
                                   lambda f: np.maximum(f - 1, 0).T),
            "detach": (x.detach() + 1, lambda f: f + 1),
            "cpu": (x.cpu() * 1, lambda f: f),
            "setitem": (y, lambda f: np.vstack([np.full((1, 3), 5.0),
                                                f[1:]])),
            "view taken before": (row, lambda f: f[1]),
            "add_": (z, lambda f: f + 10),
            "relu inplace": (torch.nn.functional.relu(x * 1, inplace=True),
                             lambda f: np.maximum(f, 0)),
            "concat": (paddle.concat([x, x.clone() * 2], axis=0),
                       lambda f: np.concatenate([f, f * 2])),
        }
    assert all(type(t).__name__ == "StaticTensor"
               for t, _ in fetches.values())
    exe = paddle.static.Executor()
    for f in (np.ones((2, 3), np.float32),
              np.arange(6, dtype=np.float32).reshape(2, 3) - 2):
        outs = exe.run(main, feed={"x": f},
                       fetch_list=[t for t, _ in fetches.values()])
        for (name, (_, want)), got in zip(fetches.items(), outs):
            np.testing.assert_allclose(got, want(f), rtol=1e-6,
                                       err_msg=name)
    assert exe._trace_count == 1


@pytest.mark.parametrize("use", [
    "item", "float", "bool", "numpy", "tolist", "data_ptr", "out=",
    "write into an outside tensor"])
def test_host_reads_of_program_values_raise(use):
    from paddle_tpu_torch.core.capture import StaticValueError

    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [2, 3], "float32")
        s = x.sum()
        act = {
            "item": lambda: s.item(), "float": lambda: float(s),
            "bool": lambda: bool(s > 0), "numpy": lambda: x.numpy(),
            "tolist": lambda: x.tolist(), "data_ptr": lambda: x.data_ptr(),
            "out=": lambda: torch.add(x, 1, out=torch.empty(2, 3)),
            "write into an outside tensor":
                lambda: torch.zeros(2, 3).copy_(x),
        }[use]
        with pytest.raises(StaticValueError, match="static capture"):
            act()


def test_multiple_fetches_share_one_compile():
    def build(P):
        x = P.static.data("x", [2], "float32")
        a = x * 2
        return [a, a + 1]

    results, exe, _ = _both(build, [{"x": np.array([1.0, 2.0], np.float32)}])
    _assert_pairs(results)
    assert exe._trace_count == 1


def test_executor_compiles_once_per_signature():
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 3], "float32")
        y = paddle.nn.functional.relu(x * 2.0 + 1.0)
    exe = paddle.static.Executor()
    f = np.random.rand(2, 3).astype(np.float32)
    exe.run(main, feed={"x": f}, fetch_list=[y])
    assert exe._trace_count == 1
    (o2,) = exe.run(main, feed={"x": f + 1}, fetch_list=[y])
    assert exe._trace_count == 1
    np.testing.assert_allclose(o2, np.maximum((f + 1) * 2 + 1, 0), rtol=1e-6)
    (o3,) = exe.run(main, feed={"x": np.random.rand(5, 3).astype(np.float32)},
                    fetch_list=[y])
    assert exe._trace_count == 2 and o3.shape == (5, 3)


def test_scope_and_create_parameter_update_without_recompile():
    scope = paddle.static.Scope()
    with paddle.static.scope_guard(scope):
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 4], "float32")
            w = paddle.static.create_parameter([4, 2], "float32", name="w")
            b = paddle.static.create_parameter([2], "float32", name="b",
                                               is_bias=True)
            y = paddle.matmul(x, w) + b
        exe = paddle.static.Executor()
        f = np.random.rand(3, 4).astype(np.float32)
        (out,) = exe.run(main, feed={"x": f}, fetch_list=[y])
        w_np = scope.find_var("w").get_tensor().numpy()
        np.testing.assert_allclose(out, f @ w_np, rtol=1e-5)
        scope.var("w").set(np.ones((4, 2), np.float32))
        (out2,) = exe.run(main, feed={"x": f}, fetch_list=[y])
        assert exe._trace_count == 1
        np.testing.assert_allclose(out2, f @ np.ones((4, 2)), rtol=1e-5)
    child = scope.new_scope()
    assert child.find_var("w") is scope.find_var("w")


def test_gradients_compile_with_feeds():
    def build(P):
        x = P.static.data("x", [None, 2], "float32")
        loss = P.sum(x * x)
        (gx,) = P.static.gradients([loss], [x])
        return [loss, gx]

    f = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    results, exe, _ = _both(build, [{"x": f}, {"x": f * 10}])
    _assert_pairs(results)
    np.testing.assert_allclose(results[1][1][1], 20 * f, rtol=1e-6)
    assert exe._trace_count == 1


def test_target_gradients_replay_with_feeds():
    def build(P):
        x = P.static.data("x", [2], "float32")
        g = P.static.data("g", [], "float32")
        (gx,) = P.static.gradients([x * x], [x], target_gradients=[g])
        return [gx]

    f = np.array([1.0, 2.0], np.float32)
    results, _, _ = _both(build, [{"x": f, "g": np.float32(3.0)},
                                  {"x": f, "g": np.float32(10.0)}])
    _assert_pairs(results)
    np.testing.assert_allclose(results[1][1][0], 20 * f, rtol=1e-6)


def test_default_param_names_unique_across_programs():
    scope = paddle.static.Scope()
    with paddle.static.scope_guard(scope):
        a = paddle.static.Program()
        with paddle.static.program_guard(a):
            xa = paddle.static.data("x", [None, 4], "float32")
            wa = paddle.static.create_parameter([4, 2])
            ya = paddle.matmul(xa, wa)
        b = paddle.static.Program()
        with paddle.static.program_guard(b):
            xb = paddle.static.data("x", [None, 8], "float32")
            wb = paddle.static.create_parameter([8, 3])
            yb = paddle.matmul(xb, wb)
        assert wa.name != wb.name
        exe = paddle.static.Executor()
        (oa,) = exe.run(a, feed={"x": np.ones((2, 4), np.float32)},
                        fetch_list=[ya])
        (ob,) = exe.run(b, feed={"x": np.ones((2, 8), np.float32)},
                        fetch_list=[yb])
        assert oa.shape == (2, 2) and ob.shape == (2, 3)


def test_save_load_params(tmp_path):
    scope = paddle.static.Scope()
    with paddle.static.scope_guard(scope):
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 2], "float32")
            w = paddle.static.create_parameter([2, 2], name="w")
            paddle.matmul(x, w)
        saved = scope.find_var("w").get_tensor().numpy().copy()
        path = str(tmp_path / "ckpt")
        paddle.static.save(main, path)
        scope.var("w").set(np.zeros((2, 2), np.float32))
        paddle.static.load(main, path)
        np.testing.assert_array_equal(scope.find_var("w").get_tensor(),
                                      saved)
    # the JAX package reads the port's file, as its own
    jscope = paddle_tpu.static.Scope()
    with paddle_tpu.static.scope_guard(jscope):
        jmain = paddle_tpu.static.Program()
        with paddle_tpu.static.program_guard(jmain):
            paddle_tpu.static.data("x", [None, 2], "float32")
            paddle_tpu.static.create_parameter([2, 2], name="w")
        paddle_tpu.static.load(jmain, path)
        np.testing.assert_array_equal(np.asarray(jscope.find_var("w")._value),
                                      saved)


def test_input_spec():
    spec = paddle.static.InputSpec([None, 8], "float32", name="x")
    assert spec.shape == (None, 8) and spec.dtype == torch.float32
    assert paddle.static.InputSpec.from_tensor(
        paddle.ones([2, 2])).shape == (2, 2)


def test_executor_rejects_unknown_and_missing_feeds():
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [2], "float32")
        g = paddle.static.data("g", [], "float32")
        y = x * g
    exe = paddle.static.Executor()
    f = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="not placeholders"):
        exe.run(main, feed={"x": f, "typo": f}, fetch_list=[y])
    with pytest.raises(ValueError, match="depend on placeholder"):
        exe.run(main, feed={"x": f}, fetch_list=[y])
    (o,) = exe.run(main, feed={"x": f, "g": np.float32(2.0)},
                   fetch_list=[y])
    np.testing.assert_allclose(o, 2.0)
    (o2,) = exe.run(main, feed={"x": f * 3}, fetch_list=[x])
    np.testing.assert_allclose(o2, 3.0)


# -- static.nn -------------------------------------------------------------------

def test_fc_gradient_step_lowers_the_loss_as_the_reference():
    def build(P):
        x = P.static.data("x", [None, 6], "float32")
        h = P.static.nn.fc(x, 8, activation="relu", name="fc1")
        out = P.static.nn.fc(h, 2, name="fc2")
        loss = P.mean(out * out)
        w = P.static.default_main_program()._params["fc1.w"]
        (gw,) = P.static.gradients([loss], [w])
        return [loss, gw]

    f = np.random.RandomState(0).rand(4, 6).astype(np.float32)
    results, exe, scopes = _both(build, [{"x": f}])
    _assert_pairs(results)
    (l1, g), losses = results[0][1], []
    for P, e in ((paddle_tpu, paddle_tpu.static.Executor()), (paddle, exe)):
        scope, main, fetches = scopes[P]
        with P.static.scope_guard(scope):
            v = scope.find_var("fc1.w")
            scope.var("fc1.w").set(np.asarray(v._value) - 0.5 * g)
            losses.append(e.run(main, feed={"x": f},
                                fetch_list=[fetches[0]])[0])
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert losses[1] < l1 and exe._trace_count == 2


def test_builders_match_reference():
    def build(P):
        ids = P.static.data("ids", [None, 5], "int64")
        emb = P.static.nn.embedding(ids, (30, 8), name="emb")
        img = P.static.data("img", [None, 3, 8, 8], "float32")
        c = P.static.nn.conv2d(img, 4, 3, padding=1, act="relu", name="c")
        return [emb, c, P.static.nn.batch_norm(c, name="bn"),
                P.static.nn.layer_norm(emb, begin_norm_axis=2),
                P.static.nn.group_norm(c, groups=2),
                P.static.nn.instance_norm(c),
                P.static.nn.prelu(c, mode="channel"),
                P.static.nn.conv3d(P.reshape(img, [-1, 3, 1, 8, 8]), 2, 1,
                                   name="c3")]

    feed = {"ids": np.random.RandomState(0).randint(0, 30, (2, 5)),
            "img": np.random.RandomState(1).rand(2, 3, 8, 8).astype(
                np.float32)}
    results, _, _ = _both(build, [feed])
    _assert_pairs(results, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(results[0][1][2].mean(axis=(0, 2, 3)), 0.0,
                               atol=1e-4)


def test_cond_in_compiled_program_matches_reference():
    def build(P):
        x = P.static.data("x", [3], "float32")
        return [P.static.nn.cond(P.sum(x) > 0, lambda: x * 2,
                                 lambda: x - 1)]

    results, exe, _ = _both(build, [{"x": np.ones(3, np.float32)},
                                    {"x": -np.ones(3, np.float32)}])
    _assert_pairs(results)
    np.testing.assert_allclose(results[1][1][0], -2.0)
    assert exe._trace_count == 1


def test_switch_case_and_case_match_reference():
    def build(P):
        i = P.static.data("i", [], "int64")
        x = P.static.data("x", [2], "float32")
        return [P.static.nn.switch_case(
            i, {0: lambda: x + 1, 1: lambda: x * 10},
            default=lambda: x * 0)]

    f = np.array([1.0, 2.0], np.float32)
    results, exe, _ = _both(build, [{"i": np.int64(k), "x": f}
                                    for k in (0, 1, 9)])
    _assert_pairs(results)
    assert exe._trace_count == 1


def test_while_loop_compiled_matches_reference():
    def build(P):
        x = P.static.data("x", [2], "float32")
        i0 = P.zeros([], "float32")
        return P.static.nn.while_loop(
            lambda i, v: P.max(P.abs(v)) > 1.0,
            lambda i, v: [i + 1, v / 2], [i0, x])

    results, exe, _ = _both(build, [
        {"x": np.array([8.0, 4.0], np.float32)},
        {"x": np.array([0.5, 0.25], np.float32)}])
    _assert_pairs(results)
    assert float(results[0][1][0]) == 3.0 and exe._trace_count == 1


# -- inference models ------------------------------------------------------------

def _infer_program(tmp_path):
    scope = paddle.static.Scope()
    with paddle.static.scope_guard(scope):
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [None, 3], "float32")
            w = paddle.static.create_parameter([3, 2], name="w")
            y = paddle.nn.functional.relu(paddle.matmul(x, w)) + 1.0
        exe = paddle.static.Executor()
        path = str(tmp_path / "infer")
        paddle.static.save_inference_model(path, [x], [y], exe)
        f = np.random.RandomState(0).rand(4, 3).astype(np.float32)
        (expect,) = exe.run(main, feed={"x": f}, fetch_list=[y])
    return path, f, expect


def test_save_load_inference_model_roundtrip(tmp_path):
    path, f, expect = _infer_program(tmp_path)
    prog, feed_names, fetch_targets = paddle.static.load_inference_model(
        path, paddle.static.Executor(), device="cpu")
    assert feed_names == ["x"]
    (got,) = paddle.static.Executor().run(prog, feed={"x": f},
                                          fetch_list=fetch_targets)
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    (got7,) = paddle.static.Executor().run(
        prog, feed={"x": np.ones((7, 3), np.float32)},
        fetch_list=fetch_targets)
    assert got7.shape == (7, 2)


def test_load_inference_model_fresh_process(tmp_path):
    path, f, expect = _infer_program(tmp_path)
    np.save(str(tmp_path / "feed.npy"), f)
    np.save(str(tmp_path / "expect.npy"), expect)
    code = textwrap.dedent(f"""
        import numpy as np, paddle_tpu_torch as paddle
        prog, feeds, fetches = paddle.static.load_inference_model(
            {path!r}, paddle.static.Executor(), device="cpu")
        f = np.load({str(tmp_path / 'feed.npy')!r})
        (got,) = paddle.static.Executor().run(prog, feed={{'x': f}},
                                              fetch_list=fetches)
        np.testing.assert_allclose(
            got, np.load({str(tmp_path / 'expect.npy')!r}), rtol=1e-5)
        print('FRESH-OK')
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FRESH-OK" in r.stdout


def test_ernie_tiny_static_program_matches_reference():
    cfg = dict(vocab=97, hidden=32, layers=2, heads=4, inter=64, seq=32)
    from paddle_tpu.models import ErnieForSequenceClassification as JCls
    from paddle_tpu.models import ernie_tiny as j_tiny

    paddle_tpu.seed(0)
    jm = JCls(j_tiny(**cfg), num_classes=2)
    jm.eval()
    tm = ErnieForSequenceClassification(ernie_tiny(**cfg), device="cpu")
    tm.set_state_dict(ernie_state_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}, tm))
    tm.eval()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        ids = paddle.static.data("input_ids", [None, 16], "int64")
        logits = tm(ids)
    exe = paddle.static.Executor()
    for b in (2, 3):
        feed = np.random.RandomState(b).randint(0, 97, (b, 16))
        (got,) = exe.run(main, feed={"input_ids": feed}, fetch_list=[logits])
        want = jm(paddle_tpu.to_tensor(feed)).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
