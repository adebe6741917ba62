"""Optimizers (counterpart of paddle_tpu/optimizer)."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
