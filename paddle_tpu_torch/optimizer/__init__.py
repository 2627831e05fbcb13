from . import lr
from .lbfgs import LBFGS
from .lr import (CosineAnnealingDecay, CosineAnnealingWarmRestarts, CyclicLR,
                 ExponentialDecay, InverseTimeDecay, LambdaDecay,
                 LinearWarmup, LRScheduler, MultiplicativeDecay,
                 MultiStepDecay, NaturalExpDecay, NoamDecay, OneCycleLR,
                 PiecewiseDecay, PolynomialDecay, ReduceOnPlateau, StepDecay)
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LBFGS", "lr",
           *lr.__all__]
