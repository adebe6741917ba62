"""Device and dtype resolution (counterpart of paddle_tpu/core)."""
from .dtype import resolve_dtype  # noqa: F401
from .place import resolve_device  # noqa: F401
