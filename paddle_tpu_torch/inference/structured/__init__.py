"""Structured decoding (counterpart of paddle_tpu/inference/structured):
so far the n-gram speculator. The grammar compilers and the arena are
ROADMAP A9."""
