"""Counterpart of paddle_tpu/distributed/fleet."""
