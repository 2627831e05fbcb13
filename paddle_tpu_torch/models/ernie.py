"""ERNIE (counterpart of ``paddle_tpu/models/ernie.py``; ``BASELINE.md``
config #3, ERNIE-3.0-Base masked-LM pretraining): a BERT-style
bidirectional encoder with word, position and token-type embeddings, a
pooler, and the MLM and sequence-classification heads.

The attribute names are the reference's, so a state dict converts key for
key (``models/convert.py`` ``ernie_state_from_jax``). The encoder is
``nn.TransformerEncoder``: per layer two LayerNorm kernels and the flash
kernels with in-kernel attention dropout when no padding mask is given;
a padding mask becomes an additive float bias, which the reference routes
to the einsum composition so that it differentiates. Entry points build on
``cuda`` unless ``device="cpu"``, with weights drawn from ``generator``
(or a fresh one seeded with ``seed``; default ``framework.random``'s
generator of the device): Xavier-uniform linear weights, zero biases,
N(0, 1) embeddings, LayerNorm at 1 and 0, the reference's initialisers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device
from ..framework.random import weights_generator
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, TransformerEncoder
from ..nn.layers import TransformerEncoderLayer

__all__ = ["ErnieConfig", "ernie_base", "ernie_tiny", "ErnieEmbeddings",
           "ErnieModel", "ErnieForMaskedLM", "ErnieForSequenceClassification"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1


def ernie_base():
    """ERNIE-3.0-Base (PaddleNLP ``ernie-3.0-base-zh``)."""
    return ErnieConfig()


def ernie_tiny(vocab=512, hidden=64, layers=2, heads=4, inter=128, seq=128):
    return ErnieConfig(vocab_size=vocab, hidden_size=hidden,
                       num_hidden_layers=layers, num_attention_heads=heads,
                       intermediate_size=inter, max_position_embeddings=seq,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)


@torch.no_grad()
def _init(modules, generator):
    """The reference's initialisers on ``modules`` (and their children)."""
    for top in modules:
        for m in top.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, t = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(t, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class ErnieModel(nn.Module):
    """Returns ``(sequence [B, T, hidden], pooled [B, hidden])``."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        _init([self], weights_generator(dev, generator, seed))

    @property
    def device(self) -> torch.device:
        return self.pooler.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None:
            # [B, T] 1/0 mask -> additive [B, 1, 1, T] bias
            bias = (1.0 - attention_mask.float()) * -1e9
            attention_mask = bias[:, None, None, :]
        seq = self.encoder(h, attention_mask)
        pooled = F.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class ErnieForMaskedLM(nn.Module):
    """Returns the MLM logits ``[B, T, vocab]``."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        gen = weights_generator(dev, generator, seed)
        self.ernie = ErnieModel(cfg, dev, dtype, generator=gen)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, **kw)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, **kw)
        _init([self.transform, self.decoder], gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        return self.decoder(h)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


class ErnieForSequenceClassification(nn.Module):
    """Returns the class logits ``[B, num_classes]`` from the pooled
    output."""

    def __init__(self, cfg: ErnieConfig, num_classes=2, device=None,
                 dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        gen = weights_generator(dev, generator, seed)
        self.ernie = ErnieModel(cfg, dev, dtype, generator=gen)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes, device=dev,
                                    dtype=dtype)
        _init([self.classifier], gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
