"""Llama-2 decoder in PyTorch (counterpart of ``paddle_tpu/models/llama.py``).

The architecture and the attribute names are the reference's, so a
reference ``state_dict`` converts key for key (``models/convert.py``):
RMSNorm, rotate-half RoPE, GQA attention with a fused ``qkv_proj``, SwiGLU
MLP with a fused ``gate_up_proj``, untied ``lm_head``. The reference's
tensor-parallel layers are plain ``nn.Linear(bias=False)`` / ``nn.Embedding``
here (world size 1; tensor parallelism waits for the distributed slice).

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


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        qkv_out = (c.num_attention_heads + 2 * c.num_key_value_heads) * c.head_dim
        self.qkv_proj = nn.Linear(c.hidden_size, qkv_out, bias=False,
                                  device=device, dtype=dtype)
        self.o_proj = nn.Linear(c.num_attention_heads * c.head_dim,
                                c.hidden_size, bias=False, device=device,
                                dtype=dtype)
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
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.gate_up_proj = nn.Linear(c.hidden_size, 2 * c.intermediate_size,
                                      bias=False, device=device, dtype=dtype)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size,
                                   bias=False, device=device, dtype=dtype)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(torch.nn.functional.silu(gate) * up)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, device=device, dtype=dtype)

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
               weights; norm weights start at 1). Default: seed 0.
    """

    def __init__(self, config: LlamaConfig, device=None, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=dev, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device=dev, dtype=dtype)
             for _ in range(config.num_hidden_layers)])
        for i, layer in enumerate(self.layers):
            layer.self_attn.layer_idx = i
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=dev, dtype=dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, device=dev, dtype=dtype)
        cos, sin = _rope_tables(config.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not name.endswith("layernorm.weight") and name != "norm.weight":
                    p.normal_(0.0, INIT_STD, generator=generator)

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
