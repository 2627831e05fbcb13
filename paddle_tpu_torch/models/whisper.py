"""Whisper encoder-decoder speech recognition (counterpart of
``paddle_tpu/models/whisper.py``; Radford et al. 2022): a log-mel front end
of two convolutions (the second with stride 2) and a pre-norm gelu
Transformer encoder; a token decoder with self-attention over the tokens so
far and cross-attention over the encoder's output; a bias-free projection
to the vocabulary.

``forward(mel, tokens)`` gives teacher-forced logits: the decoder's
self-attention takes the causal float mask, which routes to the einsum
composition (``nn.functional.sdpa_ref``), as in the reference; the
encoder's self-attention and the cross-attention run the flash kernels.
``generate(mel, max_new_tokens)`` is the reference's greedy loop over
per-layer caches (``TransformerDecoder.gen_cache``): each step feeds one
token, so its attention (one query, no mask) runs the flash kernels too.
Every LayerNorm is the LayerNorm kernel: 2 a layer and a final one in the
encoder, 3 a layer and a final one in the decoder.

The attribute names are the reference's, so its parameters convert key for
key (``models/convert.py`` ``whisper_state_from_jax``). Entry points build
on ``cuda`` unless ``device="cpu"``, with weights drawn from ``generator``
(or a fresh one seeded with ``seed``; default ``framework.random``'s
generator of the device) by the reference's initialisers: Xavier-uniform
linear weights and zero biases, Kaiming-uniform convolutions with uniform
biases, ``Normal(0, 1)`` embeddings, LayerNorm at 1 and 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core import resolve_device
from ..framework.random import weights_generator
from ..nn import functional as F
from ..nn.layers import (Conv1D, LayerNorm, Transformer, TransformerDecoder,
                         TransformerDecoderLayer, TransformerEncoder,
                         TransformerEncoderLayer)
from .conformer import _init
from ..nn.layer import Layer

__all__ = ["WhisperConfig", "whisper_tiny", "WhisperEncoder",
           "WhisperDecoder", "WhisperForConditionalGeneration"]


@dataclass
class WhisperConfig:
    """Whisper-base's published widths (openai/whisper ``base``)."""
    n_mels: int = 80
    vocab_size: int = 51865
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    dropout: float = 0.0
    sot_token: int = 1
    eot_token: int = 2


def whisper_tiny(vocab=128, d_model=64, layers=2, heads=4, n_mels=16,
                 max_src=64, max_tgt=32):
    return WhisperConfig(n_mels=n_mels, vocab_size=vocab, d_model=d_model,
                         encoder_layers=layers, decoder_layers=layers,
                         num_heads=heads, ffn_dim=d_model * 2,
                         max_source_positions=max_src,
                         max_target_positions=max_tgt)


def _sinusoids(length, channels):
    """Whisper's fixed sinusoidal positional table ``[length, channels]``
    (f32, numpy)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


class WhisperEncoder(Layer):
    def __init__(self, cfg: WhisperConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.conv1 = Conv1D(cfg.n_mels, cfg.d_model, 3, padding=1, **kw)
        self.conv2 = Conv1D(cfg.d_model, cfg.d_model, 3, stride=2, padding=1,
                            **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.d_model, cfg.num_heads, cfg.ffn_dim, dropout=cfg.dropout,
            activation="gelu", normalize_before=True, **kw)
        self.layers = TransformerEncoder(enc_layer, cfg.encoder_layers,
                                         norm=LayerNorm(cfg.d_model, **kw))
        # the table in the model's dtype: a bf16 model stays bf16
        self.register_buffer("_pos", torch.tensor(
            _sinusoids(cfg.max_source_positions, cfg.d_model), **kw),
            persistent=False)

    def forward(self, mel):
        """mel ``[B, n_mels, T]`` -> ``[B, T // 2, d_model]`` (T even)."""
        h = F.gelu(self.conv1(mel))
        h = F.gelu(self.conv2(h))               # stride-2 subsample
        h = h.transpose(1, 2)
        if h.shape[1] > self._pos.shape[0]:
            raise ValueError(
                f"audio yields {h.shape[1]} frames but max_source_positions "
                f"is {self._pos.shape[0]}: trim or chunk the input")
        h = h + self._pos[:h.shape[1]]
        return self.layers(h)


class WhisperDecoder(Layer):
    def __init__(self, cfg: WhisperConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.embed_positions = nn.Embedding(cfg.max_target_positions,
                                            cfg.d_model, **kw)
        dec_layer = TransformerDecoderLayer(
            cfg.d_model, cfg.num_heads, cfg.ffn_dim, dropout=cfg.dropout,
            activation="gelu", normalize_before=True, **kw)
        self.layers = TransformerDecoder(dec_layer, cfg.decoder_layers,
                                         norm=LayerNorm(cfg.d_model, **kw))

    def forward(self, tokens, memory, cache=None, pos_offset=0):
        """Tokens at positions ``pos_offset ..``; with ``cache`` (one
        ``(Cache, StaticCache)`` per layer) returns ``(h, new_cache)``."""
        t = tokens.shape[1]
        pos = torch.arange(pos_offset, pos_offset + t, device=tokens.device)
        h = self.embed_tokens(tokens) + self.embed_positions(pos)
        tgt_mask = None
        if t > 1:
            tgt_mask = Transformer.generate_square_subsequent_mask(
                t, device=h.device)
        if cache is None:
            return self.layers(h, memory, tgt_mask)
        return self.layers(h, memory, tgt_mask, None, cache)


class WhisperForConditionalGeneration(Layer):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, **kw)
        self.decoder = WhisperDecoder(cfg, **kw)
        self.proj = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, **kw)
        _init(self, weights_generator(dev, generator, seed))

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def forward(self, mel, tokens):
        """Teacher-forced logits ``[B, T_tok, vocab]``."""
        memory = self.encoder(mel)
        return self.proj(self.decoder(tokens, memory))

    @torch.no_grad()
    def generate(self, mel, max_new_tokens=16):
        """Greedy decoding from ``sot_token`` over per-layer K/V caches (the
        reference's loop: one token of decoder work a step). A row that has
        emitted ``eot_token`` emits it from then on, and the loop stops once
        every row has; each step's argmax goes to the host for that
        bookkeeping. Returns ``[B, 1 + steps]`` int64 (the start token
        first)."""
        memory = self.encoder(mel)
        b = mel.shape[0]
        cur = torch.full((b, 1), self.cfg.sot_token, dtype=torch.int64,
                         device=memory.device)
        cache = self.decoder.layers.gen_cache(memory)
        out = [cur]
        finished = np.zeros(b, bool)
        for step in range(max_new_tokens):
            h, cache = self.decoder(cur, memory, cache=cache,
                                    pos_offset=step)
            nxt = self.proj(h[:, -1]).argmax(-1).cpu().numpy()
            nxt = np.where(finished, self.cfg.eot_token, nxt)  # pad after eot
            finished |= nxt == self.cfg.eot_token
            cur = torch.from_numpy(nxt[:, None].astype(np.int64)).to(
                memory.device)
            out.append(cur)
            if finished.all():
                break
        return torch.cat(out, dim=1)
