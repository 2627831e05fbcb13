"""The rest of the optimizer and lr surface of the port (paddle_tpu_torch)
against the JAX package, on the CPU.

- The 12 schedulers the port added, each over 100 steps against the
  reference's, within 1e-12 relative (the same Python float arithmetic in
  the same order; ``ReduceOnPlateau`` fed one seeded metric sequence), and
  their ``state_dict`` resuming a fresh scheduler.
- Adagrad, RMSProp (plain and centered, with momentum), Adadelta, Adamax,
  Lamb and AdamW's ``lr_ratio`` / ``apply_decay_param_fun``, each over 10
  steps on numpy-seeded f32 parameters and gradient sequences, within
  rtol 1e-5 / atol 1e-6 (f32 elementwise updates; XLA may fuse or reorder
  a product, and Lamb's norms sum in another order). The reference's AdamW
  accepts ``lr_ratio`` but ignores it (ROADMAP R18), so that option is held
  against the reference run with each parameter's lr scaled by its ratio;
  Lamb's ``exclude_from_weight_decay_fn`` likewise against the reference
  with ``lamb_weight_decay=0`` on the excluded parameter.
- LBFGS on a seeded quadratic, with and without the strong-Wolfe search,
  20 iterations, within 1e-5 (both drive float64 vector math; the
  closures compute the loss in f32).
- ``.pdopt`` files both ways: the reference's state of every new optimizer
  (LBFGS's history included) loads into the port and the port's into the
  reference, and the next step agrees.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.optimizer as jopt
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as T
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"w": (4, 3), "b": (3,), "s": ()}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": dict(d_model=512, warmup_steps=20, learning_rate=2.0),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.05),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.1),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.97),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[10, 40, 77],
                           gamma=0.3),
    "StepDecay": dict(learning_rate=0.5, step_size=13, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5,
                        lr_lambda=lambda e: 0.95 ** e + 0.01 * (e % 7)),
    "MultiplicativeDecay": dict(learning_rate=0.5,
                                lr_lambda=lambda e: 0.99 if e % 2 else 0.97),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=3, factor=0.5,
                            cooldown=2, min_lr=1e-3),
    "OneCycleLR": dict(max_learning_rate=0.1, total_steps=90,
                       phase_pct=0.25),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                     step_size_up=12, step_size_down=7,
                     mode="triangular2"),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=9,
                                        T_mult=2, eta_min=0.01),
}
EXTRA = {"OneCycleLR linear": ("OneCycleLR", dict(
             max_learning_rate=0.1, total_steps=90, anneal_strategy="linear",
             end_learning_rate=1e-3)),
         "CyclicLR exp_range": ("CyclicLR", dict(
             base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=8,
             mode="exp_range", exp_gamma=0.98)),
         "ReduceOnPlateau max abs": ("ReduceOnPlateau", dict(
             learning_rate=0.5, mode="max", threshold_mode="abs",
             threshold=0.05, patience=2))}
CASES = {**{n: (n, kw) for n, kw in SCHEDULERS.items()}, **EXTRA}


def _metrics(n):
    rng = np.random.RandomState(5)
    return list(np.cumsum(rng.randn(n) * 0.3) + 5.0)


def _walk(sched, n, metrics):
    out = []
    for i in range(n):
        out.append(sched())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_reference_over_100_steps(case):
    cls, kw = CASES[case]
    metrics = _metrics(100) if cls == "ReduceOnPlateau" else None
    want = _walk(getattr(jlr, cls)(**kw), 100, metrics)
    got = _walk(getattr(tlr, cls)(**kw), 100, metrics)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(np.round(want, 12))) > 1, "the case never moves the lr"


@pytest.mark.parametrize("cls", list(SCHEDULERS))
def test_scheduler_state_dict_resumes(cls):
    kw = SCHEDULERS[cls]
    metrics = _metrics(60) if cls == "ReduceOnPlateau" else None
    a = getattr(tlr, cls)(**kw)
    _walk(a, 30, metrics)
    state, at = a.state_dict(), a()
    b = getattr(tlr, cls)(**kw)
    b.set_state_dict(state)
    rest = None if metrics is None else metrics[30:]
    assert _walk(b, 30, rest) == _walk(a, 30, rest)
    # the reference takes the port's state too
    r = getattr(jlr, cls)(**kw)
    r.set_state_dict(state)
    assert r() == at


def test_the_port_has_every_reference_scheduler():
    assert set(tlr.__all__) == set(jlr.__all__)
    assert set(topt.__all__) >= set(jopt.__all__)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _params(pkg, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for name, shape in SHAPES.items():
        v = np.asarray(rng.randn(*shape), dtype=np.float32)
        if pkg is J:
            p = J.create_parameter(list(shape), "float32", name=name)
            p._value = jnp.asarray(v)
        else:
            p = T.create_parameter(list(shape), "float32", name=name)
            with torch.no_grad():
                p.copy_(torch.from_numpy(v))
        out.append(p)
    return out


def _grads(step, seed=1):
    rng = np.random.RandomState(seed * 1000 + step)
    return [np.asarray(rng.randn(*shape), dtype=np.float32)
            for shape in SHAPES.values()]


def _set_grads(pkg, params, grads):
    for p, g in zip(params, grads):
        if pkg is J:
            p._grad = jnp.asarray(g)
        else:
            p.grad = torch.from_numpy(g)


def _value(p):
    return (p.detach().numpy() if isinstance(p, torch.Tensor)
            else np.asarray(p._value))


OPTIMIZERS = {
    "Adagrad": dict(learning_rate=0.1, epsilon=1e-6,
                    initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=0.01, rho=0.9, momentum=0.5),
    "RMSProp centered": dict(learning_rate=0.01, rho=0.9, momentum=0.5,
                             centered=True, epsilon=1e-4),
    "Adadelta": dict(learning_rate=1.0, rho=0.9, epsilon=1e-6),
    "Adamax": dict(learning_rate=0.02, beta1=0.8, beta2=0.99),
    "Lamb": dict(learning_rate=0.05, lamb_weight_decay=0.01),
    "Adagrad L2": dict(learning_rate=0.1, weight_decay=0.01),
}


def _cls(name):
    return name.split(" ")[0]


def _kwargs(name):
    kw = dict(OPTIMIZERS[name])
    if name == "RMSProp":
        kw["epsilon"] = 1e-6
    return kw


def _run(pkg, name, steps=10, params=None, make=None):
    params = params or _params(pkg)
    mod = jopt if pkg is J else topt
    opt = make(mod, params) if make else getattr(mod, _cls(name))(
        parameters=params, **_kwargs(name))
    for s in range(steps):
        _set_grads(pkg, params, _grads(s))
        opt.step()
        opt.clear_grad()
    return params, opt


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference_over_10_steps(name):
    jp, jo = _run(J, name)
    tp, to = _run(T, name)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_value(a), _value(b), **TOL)
    js, ts = jo.state_dict(), to.state_dict()
    assert set(js) == set(ts)
    for k in js:
        if k != "_step_count":
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       err_msg=k, **TOL)


def test_adamw_apply_decay_param_fun_matches_reference():
    def make(mod, params):
        return mod.AdamW(learning_rate=0.05, weight_decay=0.1,
                         parameters=params,
                         apply_decay_param_fun=lambda n: n != "b")
    jp, _ = _run(J, None, make=make)
    tp, _ = _run(T, None, make=make)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_value(a), _value(b), **TOL)
    # and it changed something: "b" undecayed differs from decayed
    dp, _ = _run(T, None, make=lambda mod, ps: mod.AdamW(
        learning_rate=0.05, weight_decay=0.1, parameters=ps))
    assert not np.allclose(_value(dp[1]), _value(tp[1]))


def test_adamw_lr_ratio_equals_the_reference_at_the_scaled_lr():
    ratio = {"w": 0.5, "b": 1.0, "s": 0.25}
    tp, _ = _run(T, None, make=lambda mod, ps: mod.AdamW(
        learning_rate=0.05, weight_decay=0.1, parameters=ps,
        lr_ratio=lambda p: ratio[p.name]))
    for k, (name, r) in enumerate(ratio.items()):
        jp, _ = _run(J, None, make=lambda mod, ps, r=r: mod.AdamW(
            learning_rate=0.05 * r, weight_decay=0.1, parameters=ps))
        np.testing.assert_allclose(_value(tp[k]), _value(jp[k]),
                                   err_msg=name, **TOL)


def test_lamb_exclude_from_weight_decay_matches_reference_without_it():
    tp, _ = _run(T, None, make=lambda mod, ps: mod.Lamb(
        learning_rate=0.05, lamb_weight_decay=0.1, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: p.name == "b"))
    for k, wd in enumerate((0.1, 0.0, 0.1)):
        jp, _ = _run(J, None, make=lambda mod, ps, wd=wd: mod.Lamb(
            learning_rate=0.05, lamb_weight_decay=wd, parameters=ps))
        np.testing.assert_allclose(_value(tp[k]), _value(jp[k]), **TOL)


def test_lamb_reads_one_cycle_lr_each_step():
    def make(mod, params):
        sched = (jlr if mod is jopt else tlr).OneCycleLR(
            max_learning_rate=0.1, total_steps=10)
        return mod.Lamb(learning_rate=sched, parameters=params)

    def run(pkg):
        params = _params(pkg)
        opt = make(jopt if pkg is J else topt, params)
        for s in range(10):
            _set_grads(pkg, params, _grads(s))
            opt.step()
            opt.clear_grad()
            opt._lr_scheduler.step()
        return params
    for a, b in zip(run(T), run(J)):
        np.testing.assert_allclose(_value(a), _value(b), **TOL)


@pytest.mark.parametrize("name", ["Adagrad", "RMSProp centered", "Adadelta",
                                  "Adamax", "Lamb"])
def test_pdopt_files_both_ways(name, tmp_path):
    """5 steps, a ``.pdopt`` across, 5 more: the same parameters as 10
    steps in one package."""
    jp, jo = _run(J, name, steps=5)
    tp, to = _run(T, name, steps=5)
    J.save(jo.state_dict(), str(tmp_path / "j.pdopt"))
    T.save(to.state_dict(), str(tmp_path / "t.pdopt"))
    # the reference's file into the port (parameters at the reference's
    # values), the port's into the reference
    tp2 = _params(T)
    with torch.no_grad():
        for a, b in zip(tp2, jp):
            a.copy_(torch.from_numpy(_value(b)))
    to2 = getattr(topt, _cls(name))(parameters=tp2, **_kwargs(name))
    to2.set_state_dict(T.load(str(tmp_path / "j.pdopt")))
    jp2 = _params(J)
    for a, b in zip(jp2, tp):
        a._value = jnp.asarray(_value(b))
    jo2 = getattr(jopt, _cls(name))(parameters=jp2, **_kwargs(name))
    jo2.set_state_dict(J.load(str(tmp_path / "t.pdopt")))
    for pkg, params, opt in ((T, tp2, to2), (J, jp2, jo2)):
        for s in range(5, 10):
            _set_grads(pkg, params, _grads(s))
            opt.step()
            opt.clear_grad()
    want, _ = _run(J, name, steps=10)
    for params in (tp2, jp2):
        for a, b in zip(params, want):
            np.testing.assert_allclose(_value(a), _value(b), **TOL)


# ---------------------------------------------------------------------------
# LBFGS
# ---------------------------------------------------------------------------

def _quadratic(seed=3, n=6):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n)
    return ((a @ a.T + n * np.eye(n)) / n).astype(np.float32), \
        rng.randn(n).astype(np.float32)


def _lbfgs_setup(pkg, search, x0=None, max_iter=20, history=100):
    A, b = _quadratic()
    if x0 is None:
        x0 = np.linspace(-1, 1, len(b)).astype(np.float32)
    if pkg is J:
        p = J.create_parameter([len(b)], "float32", name="x")
        p._value = jnp.asarray(x0)
        At, bt = J.to_tensor(A), J.to_tensor(b)
    else:
        p = T.create_parameter([len(b)], "float32", name="x")
        with torch.no_grad():
            p.copy_(torch.from_numpy(x0))
        At, bt = torch.from_numpy(A), torch.from_numpy(b)
    mod = jopt if pkg is J else topt
    opt = mod.LBFGS(learning_rate=1.0, max_iter=max_iter,
                    history_size=history, line_search_fn=search,
                    parameters=[p])

    def closure():
        opt.clear_grad()
        loss = 0.5 * (p * (At @ p)).sum() - (bt * p).sum()
        loss.backward()
        return loss

    return p, opt, closure


def _loss(t):
    return float(t) if isinstance(t, torch.Tensor) else float(
        np.asarray(t._value))


@pytest.mark.parametrize("search", [None, "strong_wolfe"])
def test_lbfgs_matches_reference_on_a_quadratic(search):
    tp, to, tc = _lbfgs_setup(T, search)
    jp, jo, jc = _lbfgs_setup(J, search)
    np.testing.assert_allclose(_loss(to.step(tc)), _loss(jo.step(jc)),
                               rtol=1e-6)
    np.testing.assert_allclose(_value(tp), _value(jp), rtol=1e-5, atol=1e-5)
    A, b = _quadratic()
    # near the minimiser (the f32 loss stops the search short of it)
    np.testing.assert_allclose(_value(tp), np.linalg.solve(A, b), atol=1e-3)
    # the iterations agree; the search's evaluations near the end may not
    # (its stopping tests read f32 losses the two packages round apart)
    assert to._hist["n_iter"] == jo._hist["n_iter"]


def test_lbfgs_state_dict_both_ways(tmp_path):
    """A step of 3 iterations with a history of 2 in each package, its
    ``.pdopt`` into the other package at the other's point, one more step
    there: both land where the reference's own second step does."""
    search = "strong_wolfe"
    tp, to, tc = _lbfgs_setup(T, search, max_iter=3, history=2)
    jp, jo, jc = _lbfgs_setup(J, search, max_iter=3, history=2)
    to.step(tc)
    jo.step(jc)
    T.save(to.state_dict(), str(tmp_path / "t.pdopt"))
    J.save(jo.state_dict(), str(tmp_path / "j.pdopt"))
    tp2, to2, tc2 = _lbfgs_setup(T, search, _value(jp), 3, 2)
    to2.set_state_dict(T.load(str(tmp_path / "j.pdopt")))
    jp2, jo2, jc2 = _lbfgs_setup(J, search, _value(tp), 3, 2)
    jo2.set_state_dict(J.load(str(tmp_path / "t.pdopt")))
    assert 1 <= len(to2._hist["old_dirs"]) <= 2
    to2.step(tc2)
    jo2.step(jc2)
    jo.step(jc)
    for got in (tp2, jp2):
        np.testing.assert_allclose(_value(got), _value(jp), rtol=1e-5,
                                   atol=1e-5)
