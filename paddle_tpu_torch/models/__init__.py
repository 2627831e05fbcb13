from .convert import state_from_jax
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b, llama_tiny

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_7b", "llama_tiny",
           "state_from_jax"]
