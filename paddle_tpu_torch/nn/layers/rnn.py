"""Recurrent layers (counterpart of ``paddle_tpu/nn/layers/rnn.py``; ports
``LSTMCell``, ``RNN``, ``BiRNN`` and ``LSTM``; ``SimpleRNN``, ``GRU`` and
their cells come later).

The reference runs a layer's time loop as one ``lax.scan`` with no Pallas
kernel, so the port's is a plain loop over time in PyTorch idiom: the
input projection ``x @ w_ih^T`` (both biases folded in) for all steps in
one GEMM before the loop, ``h @ w_hh^T`` per step. Under ``amp`` O1 the
GEMMs follow autocast and the gates, ``h`` and ``c`` are kept in f32.
Gates are in Paddle's (and PyTorch's) order i, f, g, o. With
``sequence_length``, padded steps carry the last valid state and emit
zeros, as the reference masks them.

Parameter names are the reference's: ``layers.{l}.cell.weight_ih`` for one
direction, ``layers.{l}.rnn_fw.cell.*`` / ``rnn_bw.cell.*`` for two, each
cell with ``weight_ih [4H, in]``, ``weight_hh [4H, H]``, ``bias_ih``,
``bias_hh [4H]`` (the same layout in both packages: they convert as they
are), initialised ``Uniform(+-1 / sqrt(H))`` from ``generator`` (default
``framework.random``'s generator of the device). Layers build on ``cuda``
unless ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core import resolve_device
from ...framework.random import get_generator
from ..functional.common import dropout
from .common import LayerList
from ..layer import Layer

__all__ = ["LSTMCell", "RNN", "BiRNN", "LSTM"]


def _lstm_steps(xw, h, c, w_hh, order, seq_lens):
    """The time loop of one direction: ``xw [T, B, 4H]`` (the input
    projection with both biases), ``h``/``c [B, H]``; returns the outputs
    ``[T, B, H]`` and the final ``(h, c)``."""
    outs = [None] * xw.shape[0]
    for t in order:
        gates = (xw[t] + torch.nn.functional.linear(h.to(w_hh.dtype),
                                                    w_hh)).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        if seq_lens is None:
            h, c, outs[t] = h2, c2, h2
        else:
            valid = (t < seq_lens)[:, None]
            h = torch.where(valid, h2, h)
            c = torch.where(valid, c2, c)
            outs[t] = torch.where(valid, h2, 0.0)
    return torch.stack(outs), h, c


class LSTMCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        H = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_size, **kw))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H, **kw))
        self.bias_ih = nn.Parameter(torch.empty(4 * H, **kw))
        self.bias_hh = nn.Parameter(torch.empty(4 * H, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        g = generator if generator is not None else get_generator(
            self.weight_ih.device)
        std = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            p.uniform_(-std, std, generator=g)

    def get_initial_states(self, batch_ref, batch_dim_idx=0):
        z = torch.zeros(batch_ref.shape[batch_dim_idx], self.hidden_size,
                        device=self.weight_ih.device)
        return z, z

    def forward(self, inputs, states=None):
        """One step: ``inputs [B, in]``, ``states (h, c)`` -> ``(h2, (h2,
        c2))``."""
        h, c = states if states is not None else \
            self.get_initial_states(inputs)
        xw = torch.nn.functional.linear(inputs, self.weight_ih,
                                        self.bias_ih + self.bias_hh)
        _, h2, c2 = _lstm_steps(xw[None], h, c, self.weight_hh, [0], None)
        return h2, (h2, c2)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class RNN(Layer):
    """Runs ``cell`` over time (``[B, T, in]``, or ``[T, B, in]`` when
    ``time_major``); returns ``(outputs, final_states)``. An ``LSTMCell``
    takes the loop with the input GEMM hoisted; any other cell is called
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
        if isinstance(self.cell, LSTMCell):
            cell = self.cell
            xw = torch.nn.functional.linear(x, cell.weight_ih,
                                            cell.bias_ih + cell.bias_hh)
            h, c = states
            y, h, c = _lstm_steps(xw, h, c, cell.weight_hh, order, seq)
            states = (h, c)
        else:
            outs = [None] * T
            for t in order:
                out, new = self.cell(x[t], states)
                if seq is not None:
                    valid = (t < seq)[:, None]
                    out = torch.where(valid, out, 0.0)
                    new = _tree_where(valid, new, states)
                outs[t], states = out, new
            y = torch.stack(outs)
        return (y if self.time_major else y.transpose(0, 1)), states


def _tree_where(valid, new, old):
    if isinstance(new, (tuple, list)):
        return type(new)(_tree_where(valid, a, b) for a, b in zip(new, old))
    return torch.where(valid, new, old)


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


class _RNNBase(Layer):
    """Stacked, optionally bidirectional layers of LSTM cells (``SimpleRNN``
    and ``GRU`` are not ported yet), with dropout between layers."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        cell = LSTMCell
        layers = []
        for layer in range(num_layers):
            n_in = input_size if layer == 0 else \
                hidden_size * self.num_directions
            if self.bidirectional:
                layers.append(BiRNN(cell(n_in, hidden_size, **kw),
                                    cell(n_in, hidden_size, **kw),
                                    time_major=time_major))
            else:
                layers.append(RNN(cell(n_in, hidden_size, **kw),
                                  time_major=time_major))
        self.layers = LayerList(layers)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, (h_n, c_n))``, the states stacked ``[L * D, B, H]``
        (layer-major, forward before backward)."""
        x = inputs
        final_h, final_c = [], []
        nd = self.num_directions
        for layer, rnn in enumerate(self.layers):
            init = None
            if initial_states is not None:
                h0, c0 = initial_states
                init = [(h0[layer * nd + k], c0[layer * nd + k])
                        for k in range(nd)]
                init = tuple(init) if self.bidirectional else init[0]
            x, st = rnn(x, init, sequence_length)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = dropout(x, p=self.dropout, training=self.training)
            for h, c in (st if self.bidirectional else (st,)):
                final_h.append(h)
                final_c.append(c)
        return x, (torch.stack(final_h), torch.stack(final_c))


class LSTM(_RNNBase):
    """Paddle's ``LSTM``: ``forward(inputs, initial_states=None,
    sequence_length=None)`` -> ``(outputs, (h_n, c_n))``."""
