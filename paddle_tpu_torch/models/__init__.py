from .convert import state_from_jax, trainer_state_from_jax
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny
from .llama_pipeline import LlamaPipelineTrainer

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPipelineTrainer",
           "llama_7b", "llama_tiny", "state_from_jax",
           "trainer_state_from_jax"]
