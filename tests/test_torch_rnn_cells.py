"""SimpleRNN, GRU and their cells in the PyTorch port (paddle_tpu_torch)
against the JAX package on the CPU in f32, with the reference's weights
(its state dict, loaded with no missing or unexpected key).

The layers run 2 layers, bidirectional, with ``sequence_length`` (padded
steps carry the state and emit zeros), forward and backward: outputs,
final states, the input's gradient and every parameter's gradient of
``sum(out * w) + sum(h_n * v)`` for seeded cotangents, atol = rtol =
1e-5 (the same recurrences, GEMMs summed in another order). The cells
take one step from given states; ``get_initial_states`` and the return
structure (``(out, h_n)`` for SimpleRNN and GRU, ``(out, (h_n, c_n))``
for LSTM) are the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn

import paddle_tpu_torch.nn as tnn

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, IN, H = 3, 6, 5, 4


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(jlayer, tlayer):
    arrays = {n: np.asarray(p.numpy()) for n, p in jlayer.named_parameters()}
    missing, unexpected = tlayer.load_state_dict(
        {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert not missing and not unexpected
    assert {n: tuple(p.shape) for n, p in tlayer.named_parameters()} == \
        {n: a.shape for n, a in arrays.items()}
    return jlayer, tlayer


def _flat(states):
    if isinstance(states, (tuple, list)):
        return [s for st in states for s in _flat(st)]
    return [states]


def _run(layer, P, x, seq, init, cot):
    """``layer``'s outputs and final states on ``x``, and the gradients of
    the cotangent sum with respect to ``x`` and the parameters."""
    if P is torch:
        xt = torch.tensor(x, requires_grad=True)
        args = [xt, None if init is None else
                _map(init, torch.from_numpy)]
        if seq is not None:
            args.append(torch.from_numpy(seq))
    else:
        xt = paddle_tpu.to_tensor(x, stop_gradient=False)
        args = [xt, None if init is None else
                _map(init, paddle_tpu.to_tensor)]
        if seq is not None:
            args.append(paddle_tpu.to_tensor(seq))
    out, states = layer(*args)
    flat = [out] + _flat(states)
    conv = torch.from_numpy if P is torch else paddle_tpu.to_tensor
    total = sum((o * conv(c)).sum() for o, c in zip(flat, cot))
    total.backward()

    def np_(t):
        return t.detach().numpy() if P is torch else np.asarray(t.numpy())

    grads = {n: np_(p.grad) for n, p in layer.named_parameters()}
    return [np_(o) for o in flat], np_(xt.grad), grads, states


def _map(init, fn):
    if isinstance(init, tuple):
        return tuple(fn(a) for a in init)
    return fn(init)


def _compare(jlayer, tlayer, x, seq=None, init=None):
    shapes = [o.shape for o in _run_shapes(tlayer, x, seq, init)]
    cot = [_f(40 + k, *s) for k, s in enumerate(shapes)]
    jv, jx, jg, jst = _run(jlayer, paddle_tpu, x, seq, init, cot)
    tv, tx, tg, tst = _run(tlayer, torch, x, seq, init, cot)
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(tx, jx, **TOL)
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
    return tst


def _run_shapes(tlayer, x, seq, init):
    with torch.no_grad():
        args = [torch.from_numpy(x), None if init is None else
                _map(init, torch.from_numpy)]
        if seq is not None:
            args.append(torch.from_numpy(seq))
        out, states = tlayer(*args)
    return [out] + _flat(states)


SEQ = np.array([6, 3, 1], np.int64)


@pytest.mark.parametrize("mode", ["GRU", "SimpleRNN", "SimpleRNN_relu",
                                  "LSTM"])
def test_two_layer_bidirectional_with_sequence_length(mode):
    name, kw = mode.split("_")[0], {}
    if mode.endswith("relu"):
        kw["activation"] = "relu"
    paddle_tpu.seed(1)
    jlayer, tlayer = _pair(
        getattr(jnn, name)(IN, H, num_layers=2, direction="bidirect", **kw),
        getattr(tnn, name)(IN, H, num_layers=2, direction="bidirect",
                           device="cpu", **kw))
    states = _compare(jlayer, tlayer, _f(2, B, T, IN), SEQ)
    if name == "LSTM":
        h, c = states
        assert h.shape == c.shape == (4, B, H)
    else:
        assert isinstance(states, torch.Tensor) and states.shape == (4, B, H)


@pytest.mark.parametrize("name", ["GRU", "SimpleRNN"])
def test_time_major_with_initial_states(name):
    """One direction, time-major input, given initial states ``[L, B,
    H]``, no sequence_length."""
    paddle_tpu.seed(2)
    jlayer, tlayer = _pair(getattr(jnn, name)(IN, H, num_layers=2,
                                              time_major=True),
                           getattr(tnn, name)(IN, H, num_layers=2,
                                              time_major=True, device="cpu"))
    _compare(jlayer, tlayer, _f(3, T, B, IN), init=_f(4, 2, B, H))


@pytest.mark.parametrize("name", ["GRUCell", "SimpleRNNCell", "LSTMCell"])
def test_cell_step_matches_reference(name):
    """One step from given states and from ``get_initial_states``' zeros;
    the GRU's reset gate multiplies ``h W_hc^T + b_hc``."""
    paddle_tpu.seed(3)
    jcell, tcell = _pair(getattr(jnn, name)(IN, H),
                         getattr(tnn, name)(IN, H, device="cpu"))
    x = _f(5, B, IN)
    states = (_f(6, B, H), _f(7, B, H)) if name == "LSTMCell" else _f(6, B, H)
    for given in (True, False):
        jin = [paddle_tpu.to_tensor(x)]
        tin = [torch.from_numpy(x)]
        if given:
            jin.append(_map(states, paddle_tpu.to_tensor))
            tin.append(_map(states, torch.from_numpy))
        jo, jst = jcell(*jin)
        to, tst = tcell(*tin)
        for a, b in zip(_flat((jo, jst)), _flat((to, tst))):
            np.testing.assert_allclose(b.detach().numpy(),
                                       np.asarray(a.numpy()), **TOL)
    if name == "GRUCell":
        w_ih, w_hh, b_ih, b_hh = (p.detach().numpy() for p in (
            tcell.weight_ih, tcell.weight_hh, tcell.bias_ih, tcell.bias_hh))
        xi, hi = x @ w_ih.T + b_ih, states @ w_hh.T + b_hh
        sig = lambda v: 1 / (1 + np.exp(-v))    # noqa: E731
        r = sig(xi[:, :H] + hi[:, :H])
        z = sig(xi[:, H:2 * H] + hi[:, H:2 * H])
        c = np.tanh(xi[:, 2 * H:] + r * hi[:, 2 * H:])
        np.testing.assert_allclose(
            tcell(torch.from_numpy(x), torch.from_numpy(states))[0]
            .detach().numpy(), z * states + (1 - z) * c, **TOL)


def test_initial_states_and_base_class():
    cell = tnn.GRUCell(IN, H, device="cpu")
    ref = jnn.GRUCell(IN, H)
    x = np.zeros((2, 7, IN), np.float32)
    got = cell.get_initial_states(torch.from_numpy(x), batch_dim_idx=1,
                                  init_value=0.5)
    want = ref.get_initial_states(paddle_tpu.to_tensor(x), batch_dim_idx=1,
                                  init_value=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    lstm = tnn.LSTMCell(IN, H, device="cpu")
    h, c = lstm.get_initial_states(torch.zeros(3, IN))
    assert h.shape == c.shape == (3, H) and h.dtype == torch.float32
    assert isinstance(cell, tnn.RNNCellBase) and isinstance(
        lstm, tnn.RNNCellBase)
    assert cell.state_shape == (H,) and lstm.state_shape == ((H,), (H,))
    with pytest.raises(ValueError):
        tnn.SimpleRNNCell(IN, H, activation="gelu", device="cpu")
