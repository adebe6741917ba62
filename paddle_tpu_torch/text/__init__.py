"""Counterpart of paddle_tpu/text."""
