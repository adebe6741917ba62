"""paddle.nn.quant (counterpart of paddle_tpu/nn/quant): the layer-facing
weight-only quantization of `quantization.runtime` under the
reference's path. (The QAT / PTQ classes the reference also lists here
are still to port: ROADMAP A12 part 4.)"""

__all__ = ["Int8WeightOnlyLinear", "Int4WeightOnlyLinear",
           "quantize_model_int8", "quantize_model_int4"]


def __getattr__(name):
    # quantization.runtime builds on nn.Layer: bind on first use
    if name in __all__:
        from ...quantization import runtime

        return getattr(runtime, name)
    raise AttributeError(name)
