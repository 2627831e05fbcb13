"""Conformer speech encoder with its CTC and RNN-T heads (counterpart of
``paddle_tpu/models/conformer.py``; ``BASELINE.md`` config #5, "CTC +
RNNT"; Gulati et al. 2020).

A two-conv 4x time subsampling front end, then blocks of half-step
feed-forward, multi-head self-attention, the convolution module
(pointwise -> GLU -> depthwise -> batch norm -> swish -> pointwise) and a
second half-step feed-forward, each block closed by a LayerNorm; a linear
head gives ``[T', B, vocab]`` log-probs for ``ctc_loss`` (blank 0);
``ConformerForRNNT`` adds an LSTM predictor over the labels and an
additive joint network, ``[B, T', U + 1, vocab]`` logits for
``rnnt_loss``.

Per block the path runs 5 LayerNorm kernels and the flash kernels (no
mask: with in-kernel dropout at the config's rate while training, at
head_dim 36 in the default config); the loss runs the CTC alpha and beta
kernels, the RNN-T loss the RNN-T alpha and beta-gradient kernels.
Convolutions, batch norm, the projections and the LSTM are PyTorch library
calls, as the reference leaves them to XLA. The attribute names are the
reference's, so a state dict (its BN buffers included) converts key for
key (``models/convert.py`` ``conformer_state_from_jax``).

Entry points build on ``cuda`` unless ``device="cpu"``, with weights
drawn from ``generator`` (or a fresh one seeded with ``seed``; default
``framework.random``'s generator of the device) by the reference's
initialisers: Xavier-uniform linear weights and zero biases, Kaiming-uniform
convolutions with uniform biases, LayerNorm and BatchNorm at 1 and 0, the
label embedding ``Normal(0, 1)``, the LSTM ``Uniform(+-1 / sqrt(H))``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core import resolve_device
from ..framework.random import weights_generator
from ..nn import functional as F
from ..nn.layers import (LSTM, BatchNorm1D, Conv1D, Conv2D, Dropout,
                         LayerList, LayerNorm, LSTMCell, MultiHeadAttention)
from ..nn.layers.conv import _ConvNd

__all__ = ["ConformerConfig", "conformer_tiny", "ConvSubsampling",
           "FeedForwardModule", "ConvModule", "ConformerBlock",
           "ConformerEncoder", "ConformerForCTC", "ConformerForRNNT"]


@dataclass
class ConformerConfig:
    input_dim: int = 80          # log-mel features
    hidden: int = 144
    num_layers: int = 4
    num_heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    dropout: float = 0.1
    vocab_size: int = 128        # incl. blank at index 0
    subsample: int = 4           # time reduction of the conv frontend


def conformer_tiny(vocab=32, hidden=32, layers=2, heads=2):
    return ConformerConfig(input_dim=16, hidden=hidden, num_layers=layers,
                           num_heads=heads, conv_kernel=7, vocab_size=vocab,
                           dropout=0.0)


class ConvSubsampling(nn.Module):
    """Two stride-2 Conv2D blocks: 4x time reduction (the standard front
    end), then a projection of the flattened channels and frequencies."""

    def __init__(self, input_dim, hidden, **kw):
        super().__init__()
        self.conv1 = Conv2D(1, hidden, 3, stride=2, padding=1, **kw)
        self.conv2 = Conv2D(hidden, hidden, 3, stride=2, padding=1, **kw)
        self.proj = nn.Linear(hidden * ((input_dim + 3) // 4), hidden, **kw)

    def forward(self, x):
        b, t, f = x.shape                          # [B, T, F]
        h = F.relu(self.conv1(x.reshape(b, 1, t, f)))
        h = F.relu(self.conv2(h))
        b2, c, t2, f2 = h.shape
        return self.proj(h.transpose(1, 2).reshape(b2, t2, c * f2))


class FeedForwardModule(nn.Module):
    def __init__(self, cfg: ConformerConfig, **kw):
        super().__init__()
        self.norm = LayerNorm(cfg.hidden, **kw)
        self.fc1 = nn.Linear(cfg.hidden, cfg.hidden * cfg.ff_mult, **kw)
        self.fc2 = nn.Linear(cfg.hidden * cfg.ff_mult, cfg.hidden, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        h = self.dropout(F.swish(self.fc1(self.norm(x))))
        return self.dropout(self.fc2(h))


class ConvModule(nn.Module):
    """pointwise -> GLU -> depthwise -> BN -> swish -> pointwise
    (Conformer fig. 2), over ``[B, C, T]``."""

    def __init__(self, cfg: ConformerConfig, **kw):
        super().__init__()
        self.norm = LayerNorm(cfg.hidden, **kw)
        self.pw1 = Conv1D(cfg.hidden, 2 * cfg.hidden, 1, **kw)
        self.dw = Conv1D(cfg.hidden, cfg.hidden, cfg.conv_kernel,
                         padding=cfg.conv_kernel // 2, groups=cfg.hidden,
                         **kw)
        self.bn = BatchNorm1D(cfg.hidden, **kw)
        self.pw2 = Conv1D(cfg.hidden, cfg.hidden, 1, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        h = self.norm(x).transpose(1, 2)           # [B, C, T]
        h = F.glu(self.pw1(h), axis=1)
        h = F.swish(self.bn(self.dw(h)))
        return self.dropout(self.pw2(h).transpose(1, 2))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, **kw):
        super().__init__()
        self.ff1 = FeedForwardModule(cfg, **kw)
        self.norm_attn = LayerNorm(cfg.hidden, **kw)
        self.attn = MultiHeadAttention(cfg.hidden, cfg.num_heads,
                                       dropout=cfg.dropout, **kw)
        self.conv = ConvModule(cfg, **kw)
        self.ff2 = FeedForwardModule(cfg, **kw)
        self.norm_out = LayerNorm(cfg.hidden, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        x = x + 0.5 * self.ff1(x)
        h = self.norm_attn(x)
        x = x + self.dropout(self.attn(h, h, h))
        x = x + self.conv(x)
        x = x + 0.5 * self.ff2(x)
        return self.norm_out(x)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConformerConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.subsample = ConvSubsampling(cfg.input_dim, cfg.hidden, **kw)
        self.dropout = Dropout(cfg.dropout)
        self.blocks = LayerList([ConformerBlock(cfg, **kw)
                                 for _ in range(cfg.num_layers)])

    def forward(self, feats):
        h = self.dropout(self.subsample(feats))
        for blk in self.blocks:
            h = blk(h)
        return h


@torch.no_grad()
def _init(model, generator):
    """The reference's initialisers, drawn in module order from
    ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (_ConvNd, LSTMCell)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)


class ConformerForCTC(nn.Module):
    """Encoder + linear CTC head: ``feats`` ``[B, T, input_dim]`` to
    ``[T', B, vocab]`` log-probs (f32 under ``auto_cast``, as log_softmax is
    on its black list), ready for ``ctc_loss`` with blank 0."""

    def __init__(self, cfg: ConformerConfig, device=None, dtype=torch.float32,
                 generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg, **kw)
        self.head = nn.Linear(cfg.hidden, cfg.vocab_size, **kw)
        _init(self, weights_generator(dev, generator, seed))

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, feats):
        h = self.head(self.encoder(feats))
        return F.log_softmax(h, axis=-1).transpose(0, 1)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


class ConformerForRNNT(nn.Module):
    """Encoder + LSTM predictor + additive joint network: ``feats`` ``[B, T,
    input_dim]`` and ``labels`` ``[B, U]`` to RNN-T logits ``[B, T', U + 1,
    vocab]`` for ``rnnt_loss`` (blank 0). The predictor reads ``[0; embed
    (labels)]`` (a zero start-of-sequence row); the joint is
    ``joint(swish(enc_proj(enc)[:, :, None] + pred[:, None]))``. Under
    ``auto_cast`` O1 the bf16 encoder projection plus the f32 predictor
    output is f32, by type promotion, as in the reference."""

    def __init__(self, cfg: ConformerConfig, predictor_hidden=None,
                 device=None, dtype=torch.float32, generator=None, seed=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        ph = predictor_hidden or cfg.hidden
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg, **kw)
        self.embed = nn.Embedding(cfg.vocab_size, ph, **kw)
        self.predictor = LSTM(ph, ph, **kw)
        self.enc_proj = nn.Linear(cfg.hidden, ph, **kw)
        self.joint = nn.Linear(ph, cfg.vocab_size, **kw)
        _init(self, weights_generator(dev, generator, seed))

    @property
    def device(self) -> torch.device:
        return self.joint.weight.device

    def forward(self, feats, labels):
        enc = self.enc_proj(self.encoder(feats))             # [B, T', ph]
        emb = self.embed(labels.long())                      # [B, U, ph]
        bos = emb.new_zeros(emb.shape[0], 1, emb.shape[2])
        pred, _ = self.predictor(torch.cat([bos, emb], dim=1))
        return self.joint(F.swish(enc[:, :, None] + pred[:, None]))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
