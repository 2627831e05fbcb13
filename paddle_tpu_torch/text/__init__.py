"""``paddle.text`` (counterpart of ``paddle_tpu/text/``): the linear-chain
CRF decoder ``viterbi_decode`` / ``ViterbiDecoder``. The text datasets
are not ported yet (ROADMAP)."""
from .viterbi import ViterbiDecoder, viterbi_decode

__all__ = ["ViterbiDecoder", "viterbi_decode"]
