from .random import get_generator, next_seed, seed

__all__ = ["get_generator", "next_seed", "seed"]
