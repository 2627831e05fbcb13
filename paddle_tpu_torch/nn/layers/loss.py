"""Loss layers (counterpart of ``paddle_tpu/nn/layers/loss.py``; ports
``CTCLoss``)."""
from __future__ import annotations

from torch import nn

from ..functional.loss import ctc_loss

__all__ = ["CTCLoss"]


class CTCLoss(nn.Module):
    """``ctc_loss`` with its ``blank`` and ``reduction`` fixed."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return ctc_loss(log_probs, labels, input_lengths, label_lengths,
                        self.blank, self.reduction, norm_by_times)
