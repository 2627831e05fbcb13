"""Transformer layers (counterpart of ``paddle_tpu/nn/layers/transformer.py``:
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache`` incremental
decoding API, ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``).

Attention goes through ``nn.functional.scaled_dot_product_attention``: the
flash kernels (dropout in-kernel) without a mask or with a bool mask
(``attn_mask`` / ``src_mask``, True = attend, e.g. a key-padding mask
``[B, 1, 1, S]``, passed through unchanged), the einsum composition with a
float additive mask (``Transformer.generate_square_subsequent_mask`` is
one), as the reference routes them. A decode step (one query against a
``Cache`` or a ``StaticCache``, no mask) runs the flash kernels. The
projections are ``nn.Linear`` (weights ``[out, in]``; ``models/convert.py``
transposes the reference's ``[in, out]``). As in the reference, the
encoder and decoder layers take ``weight_attr`` and ``bias_attr`` and
ignore them: their attentions keep their biases. The layers build on
``cuda`` unless ``device="cpu"`` (``core.resolve_device``).
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ...core import resolve_device
from .. import functional as F
from .common import Dropout
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    """Multi-head attention in the ``[batch, seq, embed]`` layout.

    ``cache``: a :attr:`Cache` (the running keys and values of a decode,
    ``[b, t, heads, head_dim]``) is extended by this call's projected keys
    and values along dim 1; a :attr:`StaticCache` (projected encoder keys
    and values) is read as it is. Returns ``out``, ``(out, None)`` with
    ``need_weights`` (the flash path materialises no weights), and the new
    cache appended when a cache was passed."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

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

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache``: ``key`` / ``value`` (default ``key``) projected,
        for cross-attention. ``Cache``: empty ``[b, 0, heads, head_dim]`` in
        the key's dtype with ``value=None`` (an f32 cache would promote a
        bf16 decode at its first concatenation), else ``key`` and ``value``
        projected."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        if value is None:
            k = key.new_zeros(key.shape[0], 0, self.num_heads, self.head_dim)
            return self.Cache(k, k)
        return self.Cache(self._split_heads(self.k_proj(key)),
                          self._split_heads(self.v_proj(value)))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))     # [b, t, h, d]
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            new_cache = None
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        b, t = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, t, self.embed_dim))
        outs = (out,)
        if self.need_weights:
            outs += (None,)
        if cache is not None and new_cache is not None:
            outs += (new_cache,)
        return outs[0] if len(outs) == 1 else outs


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
            **kw)
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
        """``(out, new_cache)`` when a ``Cache`` is given, else ``out``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it (so they start from
    the same weights, as in the reference)."""
    return nn.ModuleList([layer] + [copy.deepcopy(layer)
                                    for _ in range(num_layers - 1)])


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``, then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        """``(out, new_caches)`` when ``cache`` (one per layer) is given."""
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, c = layer(out, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over ``memory`` and the FFN, each
    with its LayerNorm (before the block with ``normalize_before``, else
    after the residual). ``cache`` is ``(Cache, StaticCache)``, as
    :meth:`gen_cache` makes it."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad, **kw)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``(out, (self_cache, static_cache))`` when a cache is given."""
        self_cache, static_cache = cache if cache is not None else (None, None)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if self_cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, self_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             self_cache)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  static_cache)[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (self_cache, static_cache))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache in
        ``memory``'s dtype and the cross-attention's projected memory."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer``, then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``(out, new_caches)`` when ``cache`` (one per layer) is given."""
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One ``(Cache, StaticCache)`` per layer; with ``do_zip``, the
        reference's ``[(Cache, ...), (StaticCache, ...)]``."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(nn.Module):
    """Encoder-decoder: ``forward(src, tgt)`` runs the encoder over ``src``
    and the decoder over ``tgt`` against its output. With
    ``normalize_before`` both stacks end in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            enc_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            dec_norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The causal float mask ``[length, length]``: 0 where a position may
        attend, ``-inf`` above the diagonal (f32, on ``device``, default the
        CPU; put it on the activations' device). A float mask routes to the
        einsum composition, as in the reference."""
        return torch.full((length, length), float("-inf"),
                          device=device).triu(1)
