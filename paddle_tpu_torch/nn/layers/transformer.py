"""Transformer encoder layers (counterpart of
``paddle_tpu/nn/layers/transformer.py``: ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``; the decoder and the
incremental caches come with the Whisper slice).

Attention goes through ``nn.functional.scaled_dot_product_attention``: the
flash kernels (dropout in-kernel) without a mask or with a bool mask
(``attn_mask`` / ``src_mask``, True = attend, e.g. a key-padding mask
``[B, 1, 1, S]``, passed through unchanged), the einsum composition with a
float additive mask, as the reference routes them. The projections
are ``nn.Linear`` (weights ``[out, in]``; ``models/convert.py`` transposes
the reference's ``[in, out]``). The layers build on ``cuda`` unless
``device="cpu"`` (``core.resolve_device``).
"""
from __future__ import annotations

import copy

from torch import nn

from ...core import resolve_device
from .. import functional as F
from .common import Dropout
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        kw = dict(bias=bias_attr is not False, device=resolve_device(device),
                  dtype=dtype)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = nn.Linear(self.kdim, embed_dim, **kw)
        self.v_proj = nn.Linear(self.vdim, embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention: incremental caches come with the "
                "decoder (Whisper slice, ROADMAP Queue 1)")
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))     # [b, t, h, d]
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        b, t = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, t, self.embed_dim))
        # the flash path materialises no attention weights
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            bias_attr=bias_attr, **kw)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoderLayer: incremental caches come with the "
                "decoder (Whisper slice, ROADMAP Queue 1)")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` deep copies of ``encoder_layer`` (so they start from
    the same weights, as in the reference), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoder: incremental caches come with the "
                "decoder (Whisper slice, ROADMAP Queue 1)")
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
