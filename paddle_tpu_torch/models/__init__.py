from .conformer import (ConformerConfig, ConformerEncoder, ConformerForCTC,
                        ConformerForRNNT, conformer_tiny)
from .convert import (conformer_state_from_jax, ernie_state_from_jax,
                      state_from_jax, trainer_state_from_jax,
                      vision_state_from_jax, whisper_state_from_jax)
from .ernie import (ErnieConfig, ErnieEmbeddings, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel, ernie_base,
                    ernie_tiny)
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny
from .llama_pipeline import LlamaPipelineTrainer
from .whisper import (WhisperConfig, WhisperDecoder, WhisperEncoder,
                      WhisperForConditionalGeneration, whisper_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPipelineTrainer",
           "llama_7b", "llama_tiny", "state_from_jax",
           "trainer_state_from_jax", "ernie_state_from_jax", "ErnieConfig",
           "ernie_base", "ernie_tiny", "ErnieEmbeddings", "ErnieModel",
           "ErnieForMaskedLM", "ErnieForSequenceClassification",
           "ConformerConfig", "conformer_tiny", "ConformerEncoder",
           "ConformerForCTC", "ConformerForRNNT", "conformer_state_from_jax",
           "WhisperConfig", "whisper_tiny", "WhisperEncoder", "WhisperDecoder",
           "WhisperForConditionalGeneration", "whisper_state_from_jax",
           "vision_state_from_jax"]
