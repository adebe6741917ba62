"""Model zoo (counterpart of paddle_tpu/text/models)."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  gpt_small, gpt_tiny)
