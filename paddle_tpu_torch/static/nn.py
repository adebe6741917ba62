"""paddle_tpu_torch.static.nn — control-flow + layer builders in static
style (counterpart of paddle_tpu/static/nn.py; reference:
python/paddle/static/nn/__init__.py)."""
from ..ops.control_flow import (  # noqa: F401
    case,
    cond,
    switch_case,
    while_loop,
)

__all__ = ["cond", "while_loop", "case", "switch_case"]

from .nn_build import (  # noqa: F401
    StaticRNN,
    batch_norm,
    bilinear_tensor_product,
    continuous_value_model,
    conv2d,
    conv2d_transpose,
    conv3d,
    conv3d_transpose,
    create_parameter,
    crf_decoding,
    data_norm,
    deform_conv2d,
    embedding,
    fc,
    group_norm,
    instance_norm,
    layer_norm,
    multi_box_head,
    nce,
    prelu,
    py_func,
    row_conv,
    sparse_embedding,
    spectral_norm,
)
from .sequence import (  # noqa: F401
    LoDTensor,
    sequence_concat,
    sequence_conv,
    sequence_enumerate,
    sequence_expand,
    sequence_expand_as,
    sequence_first_step,
    sequence_last_step,
    sequence_pad,
    sequence_pool,
    sequence_reshape,
    sequence_reverse,
    sequence_scatter,
    sequence_slice,
    sequence_softmax,
    sequence_unpad,
)

__all__ += [
    "fc", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "batch_norm", "instance_norm", "layer_norm", "group_norm", "data_norm",
    "embedding", "sparse_embedding", "prelu", "spectral_norm",
    "deform_conv2d", "bilinear_tensor_product", "nce", "row_conv",
    "crf_decoding", "py_func", "create_parameter", "multi_box_head",
    "continuous_value_model", "StaticRNN", "LoDTensor",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]
