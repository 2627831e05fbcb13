"""``ViterbiDecoder`` (counterpart of ``paddle_tpu/text/viterbi.py``):
linear-chain CRF max-decode over the registered ``viterbi_decode`` op."""
from __future__ import annotations

from ..ops.registry import OPS

__all__ = ["ViterbiDecoder", "viterbi_decode"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """``(scores [B], paths [B, T])`` of potentials ``[B, T, N]`` under
    ``transition_params [N, N]``."""
    return OPS["viterbi_decode"].fn(potentials, transition_params, lengths,
                                    include_bos_eos_tag=include_bos_eos_tag)


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
