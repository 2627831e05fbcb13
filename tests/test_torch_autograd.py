"""The port's autograd (``paddle_tpu_torch.core.autograd``,
``paddle_tpu_torch.autograd``) against the JAX package's tape: every case
of ``tests/test_autograd.py`` runs through both packages and the results
are compared (f32; exact where the arithmetic is exact, else rtol 1e-6,
and 1e-4 / atol 1e-5 for the second-order gradient penalty through
``tanh`` and a matmul, as that test states against ``jax.grad``).

Differences stated here: the port's ``paddle.grad(..., no_grad_vars=)``
cuts the graph at those tensors, as Paddle does; the JAX package's
``grad`` ignores the argument (ROADMAP R12).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.core import device as tdevice

torch.set_num_threads(2)
PKGS = [J, T]


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def both(case, rtol=0.0, atol=0.0):
    """Run ``case(paddle)`` through both packages and compare every array
    it returns."""
    j, t = case(J), case(T)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        if a is None or b is None:
            assert a is None and b is None
            continue
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=rtol,
                                   atol=atol)
    return j, t


def g(x):
    return None if x.grad is None else x.grad.numpy()


def test_simple_backward():
    def case(P):
        x = P.to_tensor([2.0, 3.0], stop_gradient=False)
        (x * x).sum().backward()
        return [g(x)]

    both(case)


def test_chain():
    def case(P):
        x = P.to_tensor(2.0, stop_gradient=False)
        P.exp(P.log(x) * 3.0).backward()
        return [g(x)]

    both(case, rtol=1e-6)


def test_multi_use_accumulation():
    def case(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 2.0
        (y + y * y).sum().backward()
        return [g(x)]

    both(case)


def test_grad_accumulates_across_backwards_and_clears():
    def case(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        out = g(x)
        x.clear_grad()
        return [out, g(x)]

    both(case)


def test_stop_gradient_blocks():
    def case(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        y = P.to_tensor([2.0], stop_gradient=True)
        (x * y).sum().backward()
        return [g(x), g(y)]

    both(case)


def test_detach_and_no_grad_cut_the_graph():
    for P in PKGS:
        x = P.to_tensor([1.0], stop_gradient=False)
        assert ((x * 2).detach() * 3).stop_gradient
        with P.no_grad():
            assert (x * 2).stop_gradient
        assert not (x * 2).stop_gradient


def test_stop_gradient_set_on_a_non_leaf():
    """Later uses of the tensor see no graph; the use recorded before keeps
    its edge (both packages)."""
    def case(P):
        x = P.to_tensor([2.0], stop_gradient=False)
        y = x * 3
        before = y * y
        y.stop_gradient = True
        after = y * 5
        (before + after).sum().backward()
        return [g(x), np.asarray(after.stop_gradient, np.float64)]

    both(case)


def test_stop_gradient_on_a_non_leaf_holds_for_every_later_use():
    """Indexing, slicing, reshaping, casting, ``to``, ``clone``, ``cpu``,
    ``transpose`` and an op on a cut non-leaf record no edge into its
    inputs, and give tensors that stop the gradient (both packages)."""
    def case(P):
        x = P.to_tensor([2.0, 3.0], stop_gradient=False)
        z = x * 5
        total = (z * z).sum()
        z.stop_gradient = True
        uses = [z[0] * 7, z[1:].sum() * 2, z.reshape([2, 1]).sum() * 3,
                z.astype("float64").astype("float32").sum(),
                z.to("float32").sum() * 4, z.clone().sum() * 5,
                z.cpu().sum() * 6, z.transpose([0]).sum(),
                P.concat([z, z]).sum()]
        for u in uses:
            total = total + u
        total.backward()
        return [g(x)] + [np.asarray(u.stop_gradient, np.float64)
                         for u in uses]

    j, t = both(case)
    np.testing.assert_array_equal(t[0], [100.0, 150.0])


def test_backward_nonscalar_seeds_ones_or_takes_grad_tensor():
    def case(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 2).backward()
        x2 = P.to_tensor([1.0, 2.0], stop_gradient=False)
        (x2 * 2).backward(P.to_tensor([1.0, 0.5]))
        return [g(x), g(x2)]

    both(case)


def test_grad_of_output_wrt_itself_and_of_a_cube():
    def case(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 2
        (gy,) = P.grad(y, y)
        z = P.to_tensor([2.0], stop_gradient=False)
        (gz,) = P.grad(z * z * z, z)
        return [gy.numpy(), gz.numpy(), g(z)]

    both(case)


def test_retain_graph():
    def case(P):
        x = P.to_tensor([3.0], stop_gradient=False)
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return [g(x)]

    both(case)


def test_grad_allow_unused():
    for P in PKGS:
        x = P.to_tensor([1.0], stop_gradient=False)
        z = P.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            P.grad(x * 2, [x, z])
        gx, gz = P.grad(x * 2, [x, z], allow_unused=True)
        assert gz is None
        np.testing.assert_allclose(gx.numpy(), [2.0])


def test_register_hook_and_remove():
    def case(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        seen = []

        def hook(grad):
            seen.append(grad.numpy().copy())
            return grad * 2

        h = x.register_hook(hook)
        (x * 3).sum().backward()
        first = g(x)
        h.remove()
        x.clear_grad()
        (x * 3).sum().backward()
        return [first, g(x), np.asarray(seen).reshape(-1)]

    both(case)


def test_retain_grads_intermediate():
    def case(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        y.retain_grads()
        (y * 3).sum().backward()
        return [g(y), g(x)]

    both(case)


def test_multi_output_op_grad():
    def case(P):
        x = P.to_tensor(np.array([[3.0, 1.0, 2.0]], np.float32),
                        stop_gradient=False)
        vals, idx = P.topk(x, k=2)
        vals.sum().backward()
        return [g(x), idx.numpy()]

    both(case)


def test_branching_graph():
    def case(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        ((x * 2) * (x * 3)).sum().backward()
        return [g(x)]

    both(case)


def _double(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2 + x * 0

    return Double


def test_pylayer():
    def case(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = _double(P).apply(x)
        y.sum().backward()
        return [y.numpy(), g(x)]

    both(case)
    assert type(_double(T).apply(T.to_tensor([1.0]))) is T.Tensor


def test_pylayer_with_a_non_tensor_argument_and_kwargs():
    def case(P):
        class Scale(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k, shift=0.0):
                ctx.k = k
                return x * k + shift

            @staticmethod
            def backward(ctx, grad):
                return grad * ctx.k

        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        y = Scale.apply(x, 3.0, shift=1.0)
        y.sum().backward()
        return [y.numpy(), g(x)]

    both(case)


def test_grad_flows_through_getitem_concat():
    def case(P):
        x = P.to_tensor(np.ones((2, 2), np.float32), stop_gradient=False)
        P.concat([x[0], x[1] * 2], axis=0).sum().backward()
        return [g(x)]

    both(case)


def test_double_backward_cubic():
    def case(P):
        x = P.to_tensor([2.0, -1.0], stop_gradient=False)
        (gr,) = P.grad((x * x * x).sum(), x, create_graph=True)
        (g2,) = P.grad(gr.sum(), x)
        return [gr.numpy(), g2.numpy()]

    both(case, rtol=1e-6)


def test_double_backward_of_sin_and_exp():
    xv = np.array([0.7, -1.3, 2.1], np.float32)

    def case(P):
        x = P.to_tensor(xv, stop_gradient=False)
        y = (P.sin(x) * x * x + P.exp(0.3 * x)).sum()
        (gr,) = P.grad(y, x, create_graph=True)
        (g2,) = P.grad(gr.sum(), x)
        return [gr.numpy(), g2.numpy()]

    both(case, rtol=1e-6)


def test_double_backward_mixed_partials():
    def case(P):
        x = P.to_tensor([1.5, 2.0], stop_gradient=False)
        w = P.to_tensor([3.0, -1.0], stop_gradient=False)
        (gx,) = P.grad((x * x * w).sum(), x, create_graph=True)
        (gw,) = P.grad(gx.sum(), w)
        return [gx.numpy(), gw.numpy()]

    both(case, rtol=1e-6)


def test_gradient_penalty_pattern():
    xv = np.array([[0.5, -1.0], [2.0, 0.3]], np.float32)
    wv = np.array([[1.2, 0.1], [-0.4, 0.9]], np.float32)

    def case(P):
        w = P.to_tensor(wv, stop_gradient=False)
        x = P.to_tensor(xv, stop_gradient=False)
        (gx,) = P.grad(P.tanh(x @ w).sum(), x, create_graph=True)
        pen = ((gx * gx).sum() - 1.0) ** 2
        (gw,) = P.grad(pen, w)
        return [gx.numpy(), gw.numpy()]

    both(case, rtol=1e-4, atol=1e-5)


def test_triple_backward():
    def case(P):
        x = P.to_tensor([1.5], stop_gradient=False)
        (g1,) = P.grad((x ** 4).sum(), x, create_graph=True)
        (g2,) = P.grad(g1.sum(), x, create_graph=True)
        (g3,) = P.grad(g2.sum(), x)
        return [g1.numpy(), g2.numpy(), g3.numpy()]

    both(case, rtol=1e-5)


def test_create_graph_through_pylayer_raises():
    for P in PKGS:
        class Double(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, grad):
                return grad * 2

        x = P.to_tensor([1.0], stop_gradient=False)
        y = Double.apply(x).sum()
        with pytest.raises(NotImplementedError):
            P.grad(y, x, create_graph=True)


def test_no_grad_vars_cut_the_graph_r12():
    """R12: the port cuts the graph at ``no_grad_vars`` (Paddle's rule);
    the JAX package ignores the argument and differentiates through."""
    def case(P):
        x = P.to_tensor([2.0], stop_gradient=False)
        y = x * 3
        z = y * x                   # dz/dx = 2 * 3x through both paths
        (gx,) = P.grad(z, x, no_grad_vars=[y])
        return gx.numpy()

    np.testing.assert_allclose(case(J), [12.0])
    np.testing.assert_allclose(case(T), [6.0])   # only the direct path


def test_grad_mode_switches():
    assert T.is_grad_enabled()
    with T.no_grad():
        assert not T.is_grad_enabled()
        with T.enable_grad():
            assert T.is_grad_enabled()

    @T.no_grad()
    def f(x):
        return x * 2

    x = T.to_tensor([1.0], stop_gradient=False)
    assert f(x).stop_gradient
    T.set_grad_enabled(False)
    try:
        assert (x * 2).stop_gradient
    finally:
        T.set_grad_enabled(True)


def test_gradient_and_grad_types():
    x = T.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * x).sum().backward()
    assert type(x.grad) is T.Tensor
    np.testing.assert_array_equal(x.gradient(), [2.0, 4.0])
    (gx,) = T.grad((x * x).sum(), x)
    assert type(gx) is T.Tensor
