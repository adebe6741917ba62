"""Counterpart of paddle_tpu/distributed/fleet/meta_parallel."""
