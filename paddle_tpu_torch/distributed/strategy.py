"""DistributedStrategy: one typed config tree for all parallelism knobs
(counterpart of ``paddle_tpu/distributed/strategy.py``, a copy).

Paddle's protobuf-backed ``DistributedStrategy`` (``hybrid_configs``) and
its auto-parallel ``Strategy`` as plain dataclasses: the values feed mesh
construction (``mesh.build_mesh``) and the train-step builders
(``engine.DistributedEngine``) directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["DistributedStrategy", "HybridConfig", "AmpConfig",
           "RecomputeConfig", "ShardingConfig"]


@dataclass
class HybridConfig:
    """Degrees for each mesh axis (Paddle's ``hybrid_configs``)."""

    dp_degree: int = 1
    mp_degree: int = 1  # tensor parallel
    pp_degree: int = 1  # pipeline parallel
    sharding_degree: int = 1  # ZeRO axis
    sep_degree: int = 1  # sequence/context parallel
    ep_degree: int = 1  # expert parallel

    # pipeline schedule: "fthenb" (fill-drain) | "1f1b" | "interleave"
    pp_schedule: str = "1f1b"
    pp_micro_batches: int = 1


@dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"  # O1 = selective cast, O2 = pure low precision
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = True  # only meaningful for float16
    custom_white_list: tuple = ()
    custom_black_list: tuple = ()


@dataclass
class RecomputeConfig:
    enable: bool = False
    # names of sublayers to checkpoint; empty = every transformer block
    checkpoint_layers: tuple = ()


@dataclass
class ShardingConfig:
    stage: int = 1  # ZeRO stage 1/2/3
    offload: bool = False


@dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    amp: AmpConfig = field(default_factory=AmpConfig)
    recompute: RecomputeConfig = field(default_factory=RecomputeConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    gradient_merge_steps: int = 1
    find_unused_parameters: bool = False

    def __post_init__(self):
        # accept dicts, as fleet.init(strategy=...) callers pass them
        if isinstance(self.hybrid_configs, dict):
            self.hybrid_configs = HybridConfig(**self.hybrid_configs)
        if isinstance(self.amp, dict):
            self.amp = AmpConfig(**self.amp)
        if isinstance(self.recompute, dict):
            self.recompute = RecomputeConfig(**self.recompute)
        if isinstance(self.sharding, dict):
            self.sharding = ShardingConfig(**self.sharding)

    @property
    def world_degree(self) -> int:
        h = self.hybrid_configs
        return (h.dp_degree * h.mp_degree * h.pp_degree * h.sharding_degree
                * h.sep_degree * h.ep_degree)
