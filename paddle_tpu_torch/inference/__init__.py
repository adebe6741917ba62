"""Serving (counterpart of paddle_tpu/inference)."""
from .llm_engine import (LLMEngine, LLMEngineConfig, LLMServer,  # noqa: F401
                         PagePool, PoolExhausted)
