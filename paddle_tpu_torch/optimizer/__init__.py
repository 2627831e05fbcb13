from . import lr
from .lr import (CosineAnnealingDecay, LinearWarmup, LRScheduler,
                 PolynomialDecay)
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr", "LRScheduler", "LinearWarmup",
           "PolynomialDecay", "CosineAnnealingDecay"]
