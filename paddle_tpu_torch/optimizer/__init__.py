from . import lr
from .lr import (CosineAnnealingDecay, LinearWarmup, LRScheduler,
                 PiecewiseDecay, PolynomialDecay)
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr",
           "LRScheduler", "LinearWarmup", "PiecewiseDecay", "PolynomialDecay",
           "CosineAnnealingDecay"]
