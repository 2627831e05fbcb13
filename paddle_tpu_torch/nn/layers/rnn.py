"""Recurrent layers (counterpart of ``paddle_tpu/nn/layers/rnn.py``):
``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``,
``BiRNN``, ``SimpleRNN``, ``LSTM`` and ``GRU``.

The reference runs a layer's time loop as one ``lax.scan`` with no Pallas
kernel, so the port's is a plain loop over time in PyTorch idiom: the
input projection ``x @ w_ih^T`` (with its bias, and for SimpleRNN and
LSTM the hidden bias too) for all steps in one GEMM before the loop,
``h @ w_hh^T`` per step. Under ``amp`` O1 the GEMMs follow autocast and
the gates and states are kept in f32 (f64 stays f64). The cells are the
reference's:

- SimpleRNN: ``h = act(x W_ih^T + h W_hh^T + b_ih + b_hh)``, ``act`` tanh
  or relu;
- LSTM: gates i, f, g, o (Paddle's and PyTorch's order), ``c = sig(f) c +
  sig(i) tanh(g)``, ``h = sig(o) tanh(c)``;
- GRU: gates r, z, c; the reset gate multiplies the hidden projection
  after its bias: ``c = tanh(x_c + r (h W_hc^T + b_hc))``, then ``h = z h
  + (1 - z) c``.

With ``sequence_length``, padded steps carry the last valid state and
emit zeros, as the reference masks them (a reversed direction starts from
the initial state at the last padded step).

Parameter names are the reference's: ``layers.{l}.cell.weight_ih`` for one
direction, ``layers.{l}.rnn_fw.cell.*`` / ``rnn_bw.cell.*`` for two, each
cell with ``weight_ih [G H, in]``, ``weight_hh [G H, H]``, ``bias_ih``,
``bias_hh [G H]`` (G = 1, 4, 3; the same layout in both packages: they
convert as they are), initialised ``Uniform(+-1 / sqrt(H))`` from
``generator`` (default ``framework.random``'s generator of the device).
Layers build on ``cuda`` unless ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from ...ops.registry import defop
from ..functional.common import dropout
from .common import LayerList
from ..layer import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]

_linear = torch.nn.functional.linear


def _acc(dtype):
    """The dtype a cell keeps its gates and states in: f32, or f64."""
    return torch.promote_types(dtype, torch.float32)


def _mask(t, seq_lens, new, old, out):
    """Step ``t``'s states and output under ``sequence_length``: padded rows
    keep ``old`` and emit zeros."""
    if seq_lens is None:
        return new, out
    valid = (t < seq_lens)[:, None]
    if isinstance(new, tuple):
        new = tuple(torch.where(valid, a, b) for a, b in zip(new, old))
    else:
        new = torch.where(valid, new, old)
    return new, torch.where(valid, out, 0.0)


def _simple_step(xw, h, whh, bhh, activation):
    pre = (xw + _linear(h.to(whh.dtype), whh)).to(_acc(xw.dtype))
    h2 = torch.tanh(pre) if activation == "tanh" else torch.relu(pre)
    return h2, h2


def _lstm_step(xw, states, whh, bhh, activation):
    h, c = states
    gates = (xw + _linear(h.to(whh.dtype), whh)).to(_acc(xw.dtype))
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return (h2, c2), h2


def _gru_step(xw, h, whh, bhh, activation):
    acc = _acc(xw.dtype)
    hw = _linear(h.to(whh.dtype), whh, bhh).to(acc)
    xr, xz, xc = xw.to(acc).chunk(3, dim=-1)
    hr, hz, hc = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)
    h2 = z * h + (1.0 - z) * c
    return h2, h2


_STEPS = {"RNN": _simple_step, "LSTM": _lstm_step, "GRU": _gru_step}


def time_loop(mode, x, states, order, seq_lens, wih, whh, bih, bhh,
              activation="tanh"):
    """One direction of ``mode``'s cell (``"RNN"``, ``"LSTM"`` or
    ``"GRU"``) over ``x [T, B, in]`` in time ``order``, the input GEMM
    hoisted with the biases folded in (GRU keeps the hidden bias inside its
    reset gate's product): the outputs ``[T, B, H]`` and the final states
    (``(h, c)`` for LSTM)."""
    step = _STEPS[mode]
    xw = _linear(x, wih, bih if mode == "GRU" else bih + bhh)
    outs = [None] * x.shape[0]
    for t in order:
        new, out = step(xw[t], states, whh, bhh, activation)
        states, outs[t] = _mask(t, seq_lens, new, states, out)
    return torch.stack(outs), states


class RNNCellBase(Layer):
    """A recurrent cell of ``gates`` gates over ``hidden_size``: the four
    parameters, their initialiser, ``get_initial_states`` and the time loop
    over a whole sequence (``_steps``, :func:`time_loop` of the cell's
    ``mode``)."""

    gates = 1
    mode = "RNN"
    activation = "tanh"

    def __init__(self, input_size, hidden_size, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        gh = self.gates * hidden_size
        self.weight_ih = nn.Parameter(torch.empty(gh, input_size, **kw))
        self.weight_hh = nn.Parameter(torch.empty(gh, hidden_size, **kw))
        self.bias_ih = nn.Parameter(torch.empty(gh, **kw))
        self.bias_hh = nn.Parameter(torch.empty(gh, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight_ih.device)
        std = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            p.uniform_(-std, std, generator=g)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States filled with ``init_value``: ``[batch, hidden]`` float32
        (or ``dtype``), one for SimpleRNN and GRU, ``(h, c)`` for LSTM;
        the batch from ``batch_ref.shape[batch_dim_idx]``."""
        def full():
            return torch.full(
                (batch_ref.shape[batch_dim_idx], self.hidden_size),
                init_value, dtype=dtype or torch.float32,
                device=self.weight_ih.device)

        return (full(), full()) if self.gates == 4 else full()

    def _steps(self, x, states, order, seq_lens):
        """One direction over ``x`` ``[T, B, in]``: the outputs ``[T, B,
        H]`` and the final states."""
        return time_loop(self.mode, x, states, order, seq_lens,
                         self.weight_ih, self.weight_hh, self.bias_ih,
                         self.bias_hh, self.activation)

    def forward(self, inputs, states=None):
        """One step: ``inputs [B, in]`` -> ``(output, new_states)``."""
        if states is None:
            states = self.get_initial_states(inputs)
        y, states = self._steps(inputs[None], states, [0], None)
        return y[0], states

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        if activation not in ("tanh", "relu"):
            raise ValueError(f"SimpleRNNCell: activation {activation!r}")
        super().__init__(input_size, hidden_size, **kw)
        self.activation = activation


class LSTMCell(RNNCellBase):
    gates = 4
    mode = "LSTM"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **kw):
        super().__init__(input_size, hidden_size, **kw)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    gates = 3
    mode = "GRU"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, **kw):
        super().__init__(input_size, hidden_size, **kw)


class RNN(Layer):
    """Runs ``cell`` over time (``[B, T, in]``, or ``[T, B, in]`` when
    ``time_major``); returns ``(outputs, final_states)``. The port's cells
    take their loop with the input GEMM hoisted; any other cell is called
    step by step with the same masking."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)  # [T, B]
        T = x.shape[0]
        order = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states if initial_states is not None else \
            self.cell.get_initial_states(x, batch_dim_idx=1)
        seq = None if sequence_length is None else \
            sequence_length.to(x.device)
        if isinstance(self.cell, RNNCellBase):
            y, states = self.cell._steps(x, states, order, seq)
        else:
            outs = [None] * T
            for t in order:
                out, new = self.cell(x[t], states)
                states, outs[t] = _mask(t, seq, _tuple(new), _tuple(states),
                                        out)
                if not isinstance(new, (tuple, list)):
                    states = states[0]
            y = torch.stack(outs)
        return (y if self.time_major else y.transpose(0, 1)), states


def _tuple(s):
    return tuple(s) if isinstance(s, (tuple, list)) else (s,)


class BiRNN(Layer):
    """A forward and a reversed ``RNN``; outputs concatenated on the last
    axis, states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw, bw = initial_states if initial_states is not None else (None,
                                                                    None)
        out_fw, st_fw = self.rnn_fw(inputs, fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


_CELLS = {"RNN": SimpleRNNCell, "LSTM": LSTMCell, "GRU": GRUCell}


class _RNNBase(Layer):
    """Stacked, optionally bidirectional layers of ``mode``'s cells
    (``"RNN"``, ``"LSTM"`` or ``"GRU"``), with dropout between layers."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        if mode == "RNN":
            kw["activation"] = activation

        def cell(n_in):
            return _CELLS[mode](n_in, hidden_size, **kw)

        layers = []
        for layer in range(num_layers):
            n_in = input_size if layer == 0 else \
                hidden_size * self.num_directions
            if self.bidirectional:
                layers.append(BiRNN(cell(n_in), cell(n_in),
                                    time_major=time_major))
            else:
                layers.append(RNN(cell(n_in), time_major=time_major))
        self.layers = LayerList(layers)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, h_n)`` for SimpleRNN and GRU, ``(outputs, (h_n,
        c_n))`` for LSTM, the states stacked ``[L * D, B, H]``
        (layer-major, forward before backward), as the reference's."""
        lstm = self.mode == "LSTM"
        x = inputs
        final = []
        nd = self.num_directions
        for layer, rnn in enumerate(self.layers):
            init = None
            if initial_states is not None:
                parts = initial_states if lstm else (initial_states,)
                init = [tuple(p[layer * nd + k] for p in parts)
                        for k in range(nd)]
                init = [s if lstm else s[0] for s in init]
                init = tuple(init) if self.bidirectional else init[0]
            x, st = rnn(x, init, sequence_length)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = dropout(x, p=self.dropout, training=self.training)
            final.extend(st if self.bidirectional else (st,))
        if lstm:
            return x, (torch.stack([h for h, _ in final]),
                       torch.stack([c for _, c in final]))
        return x, torch.stack(final)


class SimpleRNN(_RNNBase):
    """Paddle's ``SimpleRNN``: ``forward(inputs, initial_states=None,
    sequence_length=None)`` -> ``(outputs, h_n)``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    """Paddle's ``LSTM``: ``forward(inputs, initial_states=None,
    sequence_length=None)`` -> ``(outputs, (h_n, c_n))``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    """Paddle's ``GRU``: ``forward(inputs, initial_states=None,
    sequence_length=None)`` -> ``(outputs, h_n)``."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


@defop("rnn")
def rnn(x, h0, c0, wih, whh, bih, bhh, seq_lens=None, mode="LSTM",
        activation="tanh", reverse=False):
    """The reference's ``rnn`` op: one direction of one layer over ``x
    [batch, time, in]`` from ``h0`` / ``c0 [batch, hidden]``, the weights
    given, through the cells' own :func:`time_loop`.
    Returns ``(outputs [batch, time, hidden], h_n, c_n)``; ``c_n`` is
    ``c0`` for GRU and SimpleRNN, so the arity is fixed."""
    mode = mode if mode in ("LSTM", "GRU") else "RNN"
    zero = torch.zeros(whh.shape[0], dtype=whh.dtype, device=whh.device)
    T = x.shape[1]
    order = range(T - 1, -1, -1) if reverse else range(T)
    lstm = mode == "LSTM"
    outs, states = time_loop(
        mode, x.transpose(0, 1), (h0, c0) if lstm else h0, order, seq_lens,
        wih, whh, zero if bih is None else bih,
        zero if bhh is None else bhh, activation)
    h_n, c_n = states if lstm else (states, c0)
    return outs.transpose(0, 1), h_n, c_n
