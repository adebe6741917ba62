"""Observability (counterpart of paddle_tpu/observability); only the
FLOPs accountant is ported."""
