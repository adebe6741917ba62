"""incubate (counterpart of paddle_tpu/incubate), as far as the port
goes: the MoE layers at the reference's incubate path."""
from . import distributed  # noqa: F401

__all__ = ["distributed"]
