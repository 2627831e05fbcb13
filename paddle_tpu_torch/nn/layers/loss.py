"""Loss layers (counterpart of ``paddle_tpu/nn/layers/loss.py``; ports
``CrossEntropyLoss`` and ``CTCLoss``)."""
from __future__ import annotations


from ..functional.loss import cross_entropy, ctc_loss
from ..layer import Layer

__all__ = ["CrossEntropyLoss", "CTCLoss"]


class CrossEntropyLoss(Layer):
    """``cross_entropy`` with its options fixed: hard labels over the last
    axis with the softmax (the classifier's case) run the softmax-CE
    kernels."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(input, label, self.weight, self.ignore_index,
                             self.reduction, self.soft_label, self.axis,
                             self.use_softmax, self.label_smoothing)


class CTCLoss(Layer):
    """``ctc_loss`` with its ``blank`` and ``reduction`` fixed."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return ctc_loss(log_probs, labels, input_lengths, label_lengths,
                        self.blank, self.reduction, norm_by_times)
