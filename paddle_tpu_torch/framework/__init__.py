from .io import load, save
from .random import get_generator, next_seed, seed, weights_generator

__all__ = ["get_generator", "next_seed", "seed", "weights_generator", "save",
           "load"]
