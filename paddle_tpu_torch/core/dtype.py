"""dtype names → torch dtypes (counterpart of paddle_tpu/core/dtype.py,
restricted to the float types this slice runs)."""
import torch

__all__ = ["resolve_dtype"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


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
