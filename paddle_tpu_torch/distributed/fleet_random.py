"""The tensor-parallel RNG state tracker (counterpart of
``paddle_tpu/distributed/fleet_random.py``; Paddle's
``fleet/layers/mpu/random.py`` ``RNGStatesTracker``).

Named deterministic streams: entering ``rng_state(name)`` makes every draw
inside (``nn.functional.dropout`` and the other ``framework.random``
users) come from that stream's ``torch.Generator``. The reference keeps
the mask of a sharded tensor layout-independent (XLA partitions a mask
drawn for the full logical shape); the port keeps that property by hand:
``rng_state(name, shard_dim=d)`` draws the mask for the full logical
shape (``n`` times dim ``d``, ``n`` the mp degree) from the one stream,
which every mp rank seeds alike, and each rank takes its slice. So a
tracker-scoped dropout at TP-N equals TP-1's, bit for bit, and
replicated tensors (no ``shard_dim``) see identical masks on every rank.
``fold_axis`` derives a distinct per-rank stream instead (the
reference's ``fold_in(axis_index)``). Against the JAX package the masks
agree in distribution only (ROADMAP's sampling contract).
"""
from __future__ import annotations

import contextlib

import torch

from ..framework import random as frandom

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class _Stream:
    """One named stream: a seed, and a generator per device made from it
    at first use."""

    def __init__(self, seed):
        self.seed = int(seed)
        self._gens: dict = {}
        self.shard = None

    def generator(self, device):
        dev = torch.device(device)
        g = self._gens.get(dev)
        if g is None:
            g = self._gens[dev] = torch.Generator(device=dev)
            g.manual_seed(self.seed)
        return g

    def generators(self):
        return dict(self._gens)


class _Scoped:
    """What ``rng_state`` installs: the stream's generators, with the
    shard of the draw and an optional per-rank fold."""

    def __init__(self, stream, shard, fold):
        self.stream, self.shard, self.fold = stream, shard, fold
        self._folded: dict = {}

    def generator(self, device):
        if self.fold is None:
            return self.stream.generator(device)
        dev = torch.device(device)
        g = self._folded.get(dev)
        if g is None:
            # a per-rank stream derived from the named one and the rank
            g = self._folded[dev] = torch.Generator(device=dev)
            g.manual_seed((self.stream.seed * 1000003 + self.fold)
                          % (2 ** 63))
        return g

    def generators(self):
        return (self.stream.generators() if self.fold is None
                else dict(self._folded))


class RNGStatesTracker:
    """Named deterministic streams (Paddle's RNGStatesTracker)."""

    def __init__(self):
        self._states: dict[str, _Stream] = {}
        self._seeds: set = set()

    def reset(self):
        self._states = {}
        self._seeds = set()

    def add(self, name, seed):
        if seed in self._seeds:
            raise ValueError(f"seed {seed} already exists")
        self._seeds.add(seed)
        if name in self._states:
            raise ValueError(f"state {name} already exists")
        self._states[name] = _Stream(seed)

    def get_states_tracker(self):
        return {n: {d: g.get_state() for d, g in s.generators().items()}
                for n, s in self._states.items()}

    def set_states_tracker(self, states):
        for n, per_dev in states.items():
            for d, st in per_dev.items():
                self._states[n].generator(d).set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG, fold_axis=None,
                  shard_dim=None, group="mp"):
        """Draw from stream ``name`` inside. ``shard_dim``: the tensors
        drawn for are this rank's shards along that dim over ``group``
        (default the mp axis); the draw is for the logical shape and each
        rank keeps its slice. ``fold_axis``: a distinct stream per rank of
        that mesh axis."""
        if name not in self._states:
            raise ValueError(f"state {name} does not exist")
        shard, fold = None, None
        if shard_dim is not None or fold_axis is not None:
            from .collective import _resolve_group

            if shard_dim is not None:
                g = _resolve_group(group)
                shard = (shard_dim, g.rank, g.nranks)
            if fold_axis is not None:
                fold = _resolve_group(fold_axis).rank
        with frandom.rng_scope(_Scoped(self._states[name], shard, fold)):
            yield


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _TRACKER


def model_parallel_random_seed(seed=None):
    """Set up the tracker for a tensor-parallel job: the global generators
    get ``seed`` and the model-parallel stream ``seed + 1 + pp_rank``. The
    mp rank does not enter it (the reference's single controller has one
    process, so there it never does): every mp rank draws the same
    logical mask and keeps its slice, or folds its rank in explicitly
    (``fold_axis``)."""
    base = int(seed) if seed is not None else frandom._state["seed"] + 2718
    _TRACKER.reset()
    pp_rank = 0
    from .mesh import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        pp_rank = hcg.get_stage_id()
    _TRACKER.add(MODEL_PARALLEL_RNG, base + 1 + pp_rank)
    frandom.seed(base)
