"""Model zoo (counterpart of paddle_tpu/text/models)."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt_1p3b, gpt_medium, gpt_small,
                  gpt_tiny)
