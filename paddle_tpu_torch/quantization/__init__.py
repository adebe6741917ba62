"""Quantization (counterpart of paddle_tpu/quantization): so far the
runtime's paged-KV codecs."""
