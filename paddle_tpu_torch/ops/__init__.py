"""Counterpart of paddle_tpu/ops."""
