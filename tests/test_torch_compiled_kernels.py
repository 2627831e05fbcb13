"""Every kernel launch of the port (paddle_tpu_torch) as a registered op
(``kernels/library.py``): compiled and exported programs through every
kernel, forward and backward, on the CPU (the ops' CPU kernels are the
plain versions), against the JAX package where it has the same program.

- ``jit.to_static`` of ``llama_tiny()`` in both packages, the weights
  carried across by ``models/convert.py``: f32 logits within 1e-4 relative
  L2 (the reference's XLA and the port's aot_eager sum in other orders).
- ``static.gradients`` of the next-token softmax-CE loss with respect to
  every parameter, through ``Executor.run``, against the reference's own
  differentiation of the same loss (``jax.grad`` over its
  ``functional_call``; its ``static.gradients`` gives zeros for a Layer's
  parameters, ROADMAP R20): every gradient within 1e-4 relative L2.
- Each registered op under ``torch.export`` with a dynamic batch
  dimension: the exported program (its fake kernels traced it) run at
  another batch gives the CPU kernel's shapes, dtypes and values.
- Each kernel's ``autograd.Function`` inside a ``to_static`` program,
  forward and backward (``torch.func.grad``), bitwise equal to eager
  ``backward()`` (the same plain versions run in both); eager calls never
  dispatch through the ops.
- Compiled flash dropout: two calls of one program drop different masks;
  an explicit seed gives eager's outputs and gradients bit for bit.

The port compiles with ``aot_eager`` here (inductor's CPU compile takes
~35 s a program on this CPU); the card runs inductor (``chip_smoke.py``
``[to_static llama]``, ``[static llama grad]``, ``[compiled kernels]``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import llama_tiny as j_llama_tiny
from paddle_tpu.nn.layer import functional_call as j_functional_call
from paddle_tpu.nn.layer import functional_state as j_functional_state

import paddle_tpu_torch as paddle
from paddle_tpu_torch import jit, kernels, static
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.kernels import ctc as C
from paddle_tpu_torch.kernels import flash_attention as F
from paddle_tpu_torch.kernels import library
from paddle_tpu_torch.kernels import paged_attention as P
from paddle_tpu_torch.kernels import rnnt as R
from paddle_tpu_torch.kernels.layernorm import layernorm
from paddle_tpu_torch.kernels.rmsnorm import rmsnorm, rmsnorm_residual
from paddle_tpu_torch.kernels.softmax_ce import softmax_ce
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.convert import state_from_jax
from paddle_tpu_torch.nn.functional import cross_entropy

torch.set_num_threads(1)
OPS = torch.ops.paddle_tpu_torch


@pytest.fixture(autouse=True)
def _cpu_aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "DEFAULT_BACKEND", "aot_eager")
    prev = tdevice._state["device"]
    paddle.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# Llama through both packages' programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The reference's ``llama_tiny()`` (random norm weights, so every
    tensor's conversion shows) and the port's model loaded from it."""
    paddle_tpu.seed(0)
    jm = JLlama(j_llama_tiny())
    jm.eval()
    params, buffers = j_functional_state(jm)
    rng = np.random.RandomState(0)
    for name, p in jm.named_parameters():
        if name.endswith("norm.weight"):
            p._value = jnp.asarray(
                1 + 0.1 * rng.randn(*p.shape).astype(np.float32))
    params, buffers = j_functional_state(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu").eval()
    missing, unexpected = tm.load_state_dict(
        state_from_jax({k: np.asarray(v) for k, v in params.items()}))
    assert not missing and not unexpected
    ids = np.random.RandomState(1).randint(0, 256, (2, 8)).astype(np.int64)
    return jm, params, buffers, tm, ids


def test_to_static_llama_matches_the_reference(pair):
    jm, _, _, tm, ids = pair
    want = np.asarray(paddle_tpu.jit.to_static(jm)(
        paddle_tpu.to_tensor(ids))._value)
    before = kernels.launch_counts()
    # a StaticFunction over the model leaves its forward unpatched for the
    # next test (to_static(layer) routes the layer's own calls through it)
    got = jit.StaticFunction(tm)(torch.from_numpy(ids))
    assert kernels.launch_counts() == before     # the CPU launches nothing
    assert tuple(got.shape) == (2, 8, 256)
    assert _rel_l2(got.numpy(), want) <= 1e-4


def test_static_gradients_of_llama_match_the_reference(pair):
    jm, params, buffers, tm, ids = pair
    V = tm.config.vocab_size

    def loss_of(logits, tok):
        return cross_entropy(logits[:, :-1].reshape([-1, V]),
                             tok[:, 1:].reshape([-1]))

    main = static.Program()
    with static.program_guard(main):
        tok = static.data("ids", [None, 8], "int64")
        loss = loss_of(tm(tok), tok)
        names = [n for n, _ in tm.named_parameters()]
        grads = static.gradients([loss], list(tm.parameters()))
    exe = static.Executor()
    outs = exe.run(main, feed={"ids": ids}, fetch_list=[loss, *grads])
    assert exe._trace_count == 1

    def j_loss(p):
        logits, _ = j_functional_call(jm, p, buffers, jnp.asarray(ids))
        lp = jax.nn.log_softmax(logits[:, :-1].reshape(-1, V), -1)
        lbl = jnp.asarray(ids[:, 1:].reshape(-1))
        return -jnp.mean(jnp.take_along_axis(lp, lbl[:, None], 1))

    want_loss, want = jax.value_and_grad(j_loss)(params)
    np.testing.assert_allclose(outs[0], np.asarray(want_loss), rtol=1e-5)
    assert len(outs) - 1 == len(names) == len(want)
    for (name, p), g in zip(tm.named_parameters(), outs[1:]):
        if getattr(p, "_paddle_t", False):     # torch's [out, in] (F4)
            g = g.T
        assert _rel_l2(g, np.asarray(want[name])) <= 1e-4, name


# ---------------------------------------------------------------------------
# every op under torch.export with a dynamic batch
# ---------------------------------------------------------------------------

def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _flash_args(B, g):
    q, k, v = (torch.randn(B, 6, 4, 8, generator=g) for _ in range(3))
    return q, k, v


def _export_cases():
    """name -> (op, make(batch, generator) -> args, {arg index: batch dim},
    static arguments appended after the tensors)."""
    def flash_fwd(B, g):
        return (*_flash_args(B, g), None, True, None, 0.0, None)

    def flash_bwd(B, g):
        q, k, v = _flash_args(B, g)
        out, lse = F.flash_attention_plain(q, k, v, causal=True)
        dg = torch.randn(B, 4, 6, generator=g)
        return (q, k, v, torch.randn_like(q), lse, dg, None, True, None,
                0.0, None)

    def varlen(B, g, bwd=False):
        T = 4 * B
        q, k, v = (torch.randn(T, 4, 8, generator=g) for _ in range(3))
        cu = torch.tensor([0, 3, 9], dtype=torch.int32)
        if not bwd:
            return (q, k, v, cu, cu.clone(), 6, 6, True, None, 0.0, None)
        out, lse = F.flash_attn_varlen_plain(q, k, v, cu, cu, True)
        return (q, k, v, torch.randn_like(q), lse, torch.randn_like(lse), cu,
                cu.clone(), 6, 6, True, None, 0.0, None)

    def rms_fwd(B, g, res=False):
        x = torch.randn(B, 16, generator=g)
        return (x, torch.randn(16, generator=g),
                torch.randn(B, 16, generator=g) if res else None, 1e-5)

    def rms_bwd(B, g):
        x, w = torch.randn(B, 16, generator=g), torch.randn(16, generator=g)
        return (x, w, torch.rand(B, generator=g) + 0.5,
                torch.randn(B, 16, generator=g), None)

    def ce_fwd(B, g):
        return (torch.randn(B, 11, generator=g),
                torch.randint(0, 11, (B,), generator=g))

    def ce_bwd(B, g):
        x, y = ce_fwd(B, g)
        return (x, y, torch.logsumexp(x, -1), torch.randn(B, generator=g))

    def paged(B, g):
        pool = torch.randn(9, 2, 2, 4, 8, generator=g)
        bt = torch.randint(0, 9, (B, 2), generator=g, dtype=torch.int32)
        ctx = torch.randint(1, 9, (B,), generator=g, dtype=torch.int32)
        return (torch.randn(B, 4, 8, generator=g), pool, bt, ctx, None)

    def ctc(B, g):
        lp = torch.log_softmax(torch.randn(12, B, 7, generator=g), -1)
        labels = torch.randint(1, 7, (B, 3), generator=g)
        return (lp, labels, torch.full((B,), 12), torch.full((B,), 3), 0)

    def rnnt_alpha(B, g):
        blank = torch.log_softmax(torch.randn(B, 6, 4, generator=g), -1)
        emit = torch.log_softmax(torch.randn(B, 6, 4, generator=g), -1)
        return (blank, emit, torch.full((B,), 6), torch.full((B,), 3))

    def rnnt_beta(B, g):
        blank, emit, tl, ul = rnnt_alpha(B, g)
        alphas, ll = R.rnnt_alpha_plain(blank, emit, tl, ul)
        return (blank, emit, alphas, tl, ul, ll)

    def ln(B, g):
        return (torch.randn(B, 16, generator=g), torch.randn(16, generator=g),
                torch.randn(16, generator=g), 1e-5)

    return {
        "flash_attention_fwd": (OPS.flash_attention_fwd, flash_fwd,
                                {0: 0, 1: 0, 2: 0}),
        "flash_attention_bwd": (OPS.flash_attention_bwd, flash_bwd,
                                {0: 0, 1: 0, 2: 0, 3: 0, 4: 0, 5: 0}),
        "flash_varlen_fwd": (OPS.flash_varlen_fwd, varlen, {0: 0, 1: 0, 2: 0}),
        "flash_varlen_bwd": (OPS.flash_varlen_bwd,
                             lambda B, g: varlen(B, g, True),
                             {0: 0, 1: 0, 2: 0, 3: 0, 4: 1, 5: 1}),
        "layernorm_fwd": (OPS.layernorm_fwd, ln, {0: 0}),
        "rmsnorm_fwd": (OPS.rmsnorm_fwd, rms_fwd, {0: 0}),
        "rmsnorm_fwd_residual": (OPS.rmsnorm_fwd,
                                 lambda B, g: rms_fwd(B, g, True),
                                 {0: 0, 2: 0}),
        "rmsnorm_bwd": (OPS.rmsnorm_bwd, rms_bwd, {0: 0, 2: 0, 3: 0}),
        "softmax_ce_fwd": (OPS.softmax_ce_fwd, ce_fwd, {0: 0, 1: 0}),
        "softmax_ce_bwd": (OPS.softmax_ce_bwd, ce_bwd,
                           {0: 0, 1: 0, 2: 0, 3: 0}),
        "paged_attention": (OPS.paged_attention, paged, {0: 0, 2: 0, 3: 0}),
        "ctc_alpha": (OPS.ctc_alpha, ctc, {0: 1, 1: 0, 2: 0, 3: 0}),
        "ctc_beta": (OPS.ctc_beta, ctc, {0: 1, 1: 0, 2: 0, 3: 0}),
        "rnnt_alpha": (OPS.rnnt_alpha, rnnt_alpha, {0: 0, 1: 0, 2: 0, 3: 0}),
        "rnnt_beta_grad": (OPS.rnnt_beta_grad, rnnt_beta,
                           {0: 0, 1: 0, 2: 0, 3: 0, 4: 0, 5: 0}),
    }


EXPORT_CASES = _export_cases()


def test_every_launch_has_its_op():
    assert set(library.OPS) == {c.split("_residual")[0]
                                for c in EXPORT_CASES}
    assert not hasattr(kernels, "NotCompilable")
    assert not hasattr(kernels, "refuse_compile")


@pytest.mark.parametrize("name", list(EXPORT_CASES))
def test_op_exports_with_a_dynamic_batch(name):
    op, make, dyn = EXPORT_CASES[name]
    args = make(3, _g(1))
    n = max(i for i, a in enumerate(args) if isinstance(a, torch.Tensor)) + 1
    tensors, rest = args[:n], args[n:]

    class M(torch.nn.Module):
        def forward(self, *t):
            return op(*t, *rest)

    batch = torch.export.Dim("batch", min=2, max=64)
    spec = tuple(None if t is None or i not in dyn else {dyn[i]: batch}
                 for i, t in enumerate(tensors))
    ep = torch.export.export(M(), tuple(tensors), dynamic_shapes=(spec,),
                             strict=False)
    args5 = make(5, _g(2))
    got = ep.module()(*args5[:n])
    want = op(*args5)
    got = (got,) if isinstance(got, torch.Tensor) else got
    want = (want,) if isinstance(want, torch.Tensor) else want
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# each Function in a program, forward and backward, against eager
# ---------------------------------------------------------------------------

def _with_grads(f, n):
    def program(*a):
        *xs, cot = a

        def loss(*d):
            outs = f(*(t.view_as(t) for t in d), *xs[n:])
            return (outs[0].float() * cot).sum(), outs

        grads, outs = torch.func.grad(loss, argnums=tuple(range(n)),
                                      has_aux=True)(*xs[:n])
        return (*outs, *grads)

    def eager(*a):
        *xs, cot = a
        leaves = [x.detach().requires_grad_() for x in xs[:n]]
        outs = f(*leaves, *xs[n:])
        (outs[0].float() * cot).sum().backward()
        return (*(o.detach() for o in outs), *(x.grad for x in leaves))
    return program, eager


def _function_cases():
    g = _g(3)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=g) for _ in range(3))
    cot = torch.randn(2, 16, 4, 8, generator=g)
    mask = torch.rand(2, 1, 16, 16, generator=g) > 0.3
    cu = torch.tensor([0, 5, 12, 20], dtype=torch.int32)
    vq, vk, vv = (torch.randn(20, 4, 8, generator=g) for _ in range(3))
    x, w = torch.randn(6, 16, generator=g), torch.randn(16, generator=g)
    res = torch.randn(6, 16, generator=g)
    logits = torch.randn(6, 11, generator=g)
    labels = torch.randint(0, 11, (6,), generator=g)
    lp = torch.log_softmax(torch.randn(12, 3, 7, generator=g), -1)
    lbl = torch.randint(1, 7, (3, 3), generator=g)
    blank = torch.log_softmax(torch.randn(3, 6, 4, generator=g), -1)
    emit = torch.log_softmax(torch.randn(3, 6, 4, generator=g), -1)
    tl, ul = torch.tensor([6, 4, 5]), torch.tensor([3, 1, 2])
    return {
        "flash causal": (lambda a, b, c: F.flash_attention_fwd(
            a, b, c, causal=True), 3, (q, k, v, cot)),
        "flash mask": (lambda a, b, c: F.flash_attention_fwd(
            a, b, c, mask=mask), 3, (q, k, v, cot)),
        "flash gqa": (lambda a, b, c: F.flash_attention_fwd(
            a, b[:, :, :2], c[:, :, :2], causal=True), 3, (q, k, v, cot)),
        "flash self (q is k is v)": (lambda a: F.flash_attention_fwd(
            a, a, a), 1, (q, cot)),
        "varlen": (lambda a, b, c, u: F.flash_attn_varlen(
            a, b, c, u, u, causal=True, max_seqlen_q=8, max_seqlen_k=8), 3,
            (vq, vk, vv, cu, torch.randn(20, 4, 8, generator=g))),
        "rmsnorm": (lambda a, b: (rmsnorm(a, b, 1e-5),), 2,
                    (x, w, torch.randn(6, 16, generator=g))),
        "rmsnorm residual": (lambda a, r, b: rmsnorm_residual(a, r, b, 1e-5),
                             3, (x, res, w, torch.randn(6, 16, generator=g))),
        "layernorm": (lambda a, b, c: (layernorm(a, b, c),), 3,
                      (x, w, w.flip(0), torch.randn(6, 16, generator=g))),
        "softmax_ce": (lambda a, y: (softmax_ce(a, y),), 1,
                       (logits, labels, torch.randn(6, generator=g))),
        "ctc": (lambda a, *r: (C.ctc_lattice(a, *r),), 1,
                (lp, lbl, torch.tensor([12, 10, 11]), torch.tensor([3, 2, 3]),
                 torch.randn(3, generator=g))),
        "rnnt": (lambda a, b, *r: (R.rnnt_lattice(a, b, *r),), 2,
                 (blank, emit, tl, ul, torch.randn(3, generator=g))),
    }


FUNCTION_CASES = _function_cases()


@pytest.mark.parametrize("name", list(FUNCTION_CASES))
def test_function_in_a_program_equals_eager_bitwise(name):
    f, n, args = FUNCTION_CASES[name]
    program, eager = _with_grads(f, n)
    got = jit.to_static(program)(*args)
    want = eager(*args)
    assert len(got) == len(want)
    # q is k is v: the program sums dq + dk + dv in another order than
    # autograd's accumulation (f32 rounding); every other case bitwise
    tol = 1e-6 if name.startswith("flash self") else 0
    for a, b in zip(got, want):
        torch.testing.assert_close(torch.Tensor.detach(a), b, atol=tol,
                                   rtol=tol)


def test_paged_attention_in_a_program_equals_eager():
    g = _g(4)
    pool = torch.randn(9, 2, 2, 4, 8, generator=g)
    args = (torch.randn(3, 4, 8, generator=g), pool,
            torch.randint(0, 9, (3, 2), generator=g, dtype=torch.int32),
            torch.tensor([1, 5, 8], dtype=torch.int32))
    got = jit.to_static(P.paged_attention)(*args)
    torch.testing.assert_close(got, P.paged_attention(*args), atol=0, rtol=0)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(FUNCTION_CASES))
def test_eager_never_dispatches_through_the_ops(name):
    f, n, args = FUNCTION_CASES[name]
    _, eager = _with_grads(f, n)
    with _OpLog() as log:
        eager(*args)
    assert not [op for op in log.names if "paddle_tpu_torch" in op]


# ---------------------------------------------------------------------------
# compiled dropout
# ---------------------------------------------------------------------------

def test_compiled_flash_dropout_draws_per_call_and_an_explicit_seed_is_eager():
    g = _g(5)
    q, k, v = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    cot = torch.randn(1, 32, 2, 8, generator=g)
    unseeded = jit.to_static(
        lambda a, b, c: F.flash_attention_fwd(a, b, c, dropout_p=0.3)[0])
    assert not torch.equal(unseeded(q, k, v), unseeded(q, k, v))
    program, eager = _with_grads(
        lambda a, b, c: F.flash_attention_fwd(a, b, c, dropout_p=0.3,
                                              seed=2024), 3)
    got = jit.to_static(program)(q, k, v, cot)
    for a, b in zip(got, eager(q, k, v, cot)):
        torch.testing.assert_close(torch.Tensor.detach(a), b, atol=0, rtol=0)
