"""dtype names → torch dtypes (counterpart of paddle_tpu/core/dtype.py).

`resolve_dtype` takes the float types a model's weights may hold
("float32" / "bfloat16"), and refuses the rest. `convert_dtype` is the
tensor API's: every paddle dtype name ("int64", "bool", "fp16", ...),
a numpy dtype, a torch dtype, or the Python types `bool` / `int` /
`float` (the last one the default dtype). The constants (`float32`,
`int64`, `bool_`, ...) are the torch dtypes themselves, so
`x.dtype == paddle.float32` holds for a torch tensor.
"""
import numpy as np
import torch

__all__ = ["resolve_dtype", "convert_dtype", "get_default_dtype",
           "set_default_dtype", "is_floating_point", "is_integer",
           "is_complex", "dtype_name", "bool_", "int8", "int16", "int32",
           "int64", "uint8", "float16", "bfloat16", "float32", "float64",
           "complex64", "complex128"]

bool_ = torch.bool
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}

_NAME_TO_DTYPE = {
    "bool": bool_, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": float16, "fp16": float16, "bfloat16": bfloat16,
    "bf16": bfloat16, "float32": float32, "fp32": float32,
    "float64": float64, "fp64": float64, "complex64": complex64,
    "complex128": complex128,
}

_FLOATING = {float16, bfloat16, float32, float64}
_COMPLEX = {complex64, complex128}

_default_dtype = float32


def resolve_dtype(dtype):
    """"float32" / "bfloat16" (or the torch dtype itself) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}: use one of {sorted(_DTYPES)}"
        ) from None


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


def convert_dtype(dtype):
    """A paddle dtype name, numpy dtype, torch dtype or Python type →
    torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype name: {dtype!r}") from None
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return _default_dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"Cannot convert {dtype!r} to a dtype") from None
    return convert_dtype(name)


def dtype_name(dtype):
    """torch dtype → the paddle name ("float32", "int64", "bool")."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def is_floating_point(dtype):
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype):
    d = convert_dtype(dtype)
    return not (d in _FLOATING or d in _COMPLEX or d == bool_)


def is_complex(dtype):
    return convert_dtype(dtype) in _COMPLEX
