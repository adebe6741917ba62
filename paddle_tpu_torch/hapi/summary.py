"""`paddle.summary` (counterpart of paddle_tpu/hapi/summary.py; reference
python/paddle/hapi/model_summary.py:1)."""
from .model import summary as _model_summary

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None):
    return _model_summary(net, input_size, dtypes)
