"""Llama-2 decoder in PyTorch (counterpart of ``paddle_tpu/models/llama.py``).

The architecture and the attribute names are the reference's, so a
reference ``state_dict`` converts key for key (``models/convert.py``):
RMSNorm, rotate-half RoPE, GQA attention with a fused ``qkv_proj``, SwiGLU
MLP with a fused ``gate_up_proj``, untied ``lm_head``. The projections are
the reference's tensor-parallel layers (``distributed.mp_layers``): with
an mp group of more than one rank (the active mesh's, or ``mp_group=``)
each rank holds its heads of ``qkv_proj`` (its part of q, of k and of v),
its halves of ``gate_up_proj``'s gate and up, its rows of ``o_proj`` and
``down_proj``, its vocabulary rows of the embedding and of the head;
with one rank they are plain products and issue no collective. The
initial weights are the logical ones at any degree (each rank draws the
whole weight from the same generator and keeps its shard).

Kernels on this path: RMSNorm twice per layer and once at the head, and
flash attention for the no-cache forward; both are differentiable
(``autograd.Function``s whose backwards are kernels too), so the no-cache
forward trains (``models.llama_pipeline``). A cache view passed as
``cache=`` (``serving.DenseKVCache`` or ``serving.PagedCacheView``) takes
over attention for cached decode, which runs without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding, mp_info)
from ..nn import functional as F
from ..nn.layers import RMSNorm
from ..nn.layer import Layer

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaDecoderLayer",
           "LlamaAttention", "LlamaMLP", "llama_tiny", "llama_7b",
           "apply_rope", "apply_rope_at"]

INIT_STD = 0.02   # std of the seeded normal init of linear/embedding weights


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama_7b():
    return LlamaConfig()


def llama_tiny(vocab=256, hidden=64, layers=4, heads=4, kv_heads=2, inter=128,
               seq=128):
    return LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
        num_hidden_layers=layers, num_attention_heads=heads,
        num_key_value_heads=kv_heads, max_position_embeddings=seq)


def _rope_tables(head_dim, max_seq, theta, device=None, dtype=torch.float32):
    """cos/sin tables [max_seq, head_dim / 2], computed in float64 with
    numpy as the reference does, then cast."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv_freq)
    return (torch.as_tensor(np.cos(freqs), dtype=dtype, device=device),
            torch.as_tensor(np.sin(freqs), dtype=dtype, device=device))


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; rotate-half RoPE at positions 0..S-1."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, : x.shape[1], None, :]
    s = sin[None, : x.shape[1], None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def apply_rope_at(x, cos, sin, positions):
    """RoPE at explicit token positions (int [B, S] or [S])."""
    d2 = x.shape[-1] // 2
    if positions.dim() == 1:
        positions = positions[None]
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def _tp(device, dtype, generator, mp_group):
    """The keyword arguments every projection of one model shares."""
    return dict(device=device, dtype=dtype, generator=generator,
                mp_group=mp_group, init=f"normal:{INIT_STD}")


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator=None, mp_group=None):
        super().__init__()
        c = config
        _, _, n = mp_info(mp_group)
        if c.num_key_value_heads % n:
            raise ValueError(f"{c.num_key_value_heads} KV heads do not split "
                             f"over {n} mp ranks")
        self.num_heads = c.num_attention_heads // n
        self.num_kv_heads = c.num_key_value_heads // n
        self.head_dim = c.head_dim
        q, kv = c.num_attention_heads * c.head_dim, \
            c.num_key_value_heads * c.head_dim
        kw = _tp(device, dtype, generator, mp_group)
        self.qkv_proj = ColumnParallelLinear(
            c.hidden_size, q + 2 * kv, has_bias=False, gather_output=False,
            segments=[q, kv, kv], **kw)
        self.o_proj = RowParallelLinear(q, c.hidden_size, has_bias=False,
                                        input_is_parallel=True, **kw)
        self.layer_idx = 0  # set by LlamaForCausalLM for KV-cache routing

    def forward(self, x, rope_cos, rope_sin, cache=None, positions=None):
        B, S = x.shape[0], x.shape[1]
        q_sz = self.num_heads * self.head_dim
        kv_sz = self.num_kv_heads * self.head_dim
        q, k, v = self.qkv_proj(x).split([q_sz, kv_sz, kv_sz], dim=-1)
        q = q.reshape(B, S, self.num_heads, self.head_dim)
        k = k.reshape(B, S, self.num_kv_heads, self.head_dim)
        v = v.reshape(B, S, self.num_kv_heads, self.head_dim)
        if positions is None:
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        else:
            q = apply_rope_at(q, rope_cos, rope_sin, positions)
            k = apply_rope_at(k, rope_cos, rope_sin, positions)
        if cache is None:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            # duck-typed KV-cache hook: the cache absorbs this layer's new
            # K/V and returns attention over the full context
            out = cache.attend(self.layer_idx, q, k, v)
        return self.o_proj(out.reshape(B, S, q_sz))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator=None, mp_group=None):
        super().__init__()
        c = config
        kw = _tp(device, dtype, generator, mp_group)
        self.gate_up_proj = ColumnParallelLinear(
            c.hidden_size, 2 * c.intermediate_size, has_bias=False,
            gather_output=False,
            segments=[c.intermediate_size, c.intermediate_size], **kw)
        self.down_proj = RowParallelLinear(c.intermediate_size,
                                           c.hidden_size, has_bias=False,
                                           input_is_parallel=True, **kw)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(torch.nn.functional.silu(gate) * up)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator=None, mp_group=None):
        super().__init__()
        eps = config.rms_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, **kw)
        self.self_attn = LlamaAttention(config, generator=generator,
                                        mp_group=mp_group, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                **kw)
        self.mlp = LlamaMLP(config, generator=generator, mp_group=mp_group,
                            **kw)

    def forward(self, x, rope_cos, rope_sin, cache=None, positions=None):
        h = x + self.self_attn(self.input_layernorm(x), rope_cos, rope_sin,
                               cache=cache, positions=positions)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaForCausalLM(Layer):
    """Causal LM.

    device:    ``None`` runs on ``cuda`` (raises without a GPU); pass
               ``"cpu"`` to build on the CPU.
    dtype:     parameter dtype (the RoPE tables stay f32).
    generator: a ``torch.Generator`` on the model's device for the seeded
               init (normal, std ``INIT_STD``, for the linear and embedding
               weights, drawn whole in parameter order; norm weights start
               at 1). Default: seed 0.
    mp_group:  the tensor-parallel group (default: the active mesh's mp
               axis; none, one rank, without a mesh).
    layers:    the global indices of the decoder layers this model holds
               (a pipeline stage's; default all). Every layer's weights are
               drawn all the same, so a stage holds the weights the whole
               model would.
    """

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None, mp_group=None,
                 layers=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        keep = (set(range(config.num_hidden_layers)) if layers is None
                else set(layers))
        kw = dict(device=dev, dtype=dtype, generator=generator,
                  mp_group=mp_group)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw,
            init=f"normal:{INIT_STD}")
        built = []
        for i in range(config.num_hidden_layers):
            layer = LlamaDecoderLayer(config, **kw)
            layer.self_attn.layer_idx = i
            if i in keep:
                built.append(layer)
        self.layers = nn.ModuleList(built)
        self.layer_ids = sorted(keep)
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=dev, dtype=dtype)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=True, **kw, init=f"normal:{INIT_STD}")
        cos, sin = _rope_tables(config.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids, cache=None, positions=None):
        """Causal-LM forward; returns logits [B, S, vocab].

        cache:     None (full causal forward through the flash kernel) or
                   a KV cache view (``serving.DenseKVCache``,
                   ``serving.PagedCacheView``) that absorbs each layer's
                   new K/V and answers attention over past + new; the
                   cached path runs without autograd.
        positions: int [B, S] RoPE positions when the inputs are a suffix
                   (cached decode); defaults to 0..S-1.
        """
        if cache is None:
            return self._forward_body(input_ids, None, positions)
        with torch.no_grad():
            return self._forward_body(input_ids, cache, positions)

    def _forward_body(self, input_ids, cache, positions):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, self.rope_cos, self.rope_sin, cache=cache,
                      positions=positions)
        return self.lm_head(self.norm(h))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
