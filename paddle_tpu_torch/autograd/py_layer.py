"""Custom autograd ops (counterpart of paddle_tpu/autograd/py_layer.py).

A `PyLayer` subclass writes `forward(ctx, *args, **kwargs)` and
`backward(ctx, *grads)` as static methods; `apply` runs them as a
`torch.autograd.Function` made once per subclass. `backward` returns a
gradient for each tensor argument of `forward`, in order (non-tensor
arguments take none). The context keeps the reference's names:
`save_for_backward` / `saved_tensor()` (kept through torch's saved
tensors, so an in-place change after forward is caught),
`mark_non_differentiable`, `mark_not_inplace` and
`set_materialize_grads`.
"""
import torch

__all__ = ["PyLayer", "PyLayerContext", "PyLayerMeta"]


class PyLayerContext:
    def __init__(self):
        self.saved_tensor_list = []
        self._materialize_grads = True
        self._non_differentiable = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self.saved_tensor_list = list(tensors)

    def saved_tensor(self):
        return self.saved_tensor_list

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tensors

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable = tensors

    def set_materialize_grads(self, value):
        self._materialize_grads = bool(value)


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Function(torch.autograd.Function):
        @staticmethod
        def forward(fctx, kwargs, *args):
            ctx = PyLayerContext()
            out = cls.forward(ctx, *args, **kwargs)
            if isinstance(out, list):
                out = tuple(out)
            fctx.save_for_backward(*ctx.saved_tensor_list)
            if ctx._non_differentiable:
                fctx.mark_non_differentiable(*ctx._non_differentiable)
            fctx.set_materialize_grads(ctx._materialize_grads)
            fctx.pyctx = ctx
            fctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            return out

        @staticmethod
        def backward(fctx, *grads):
            ctx = fctx.pyctx
            ctx.saved_tensor_list = list(fctx.saved_tensors)
            got = cls.backward(ctx, *grads)
            got = list(got) if isinstance(got, (tuple, list)) else [got]
            out = [None]
            for is_t in fctx.is_tensor:
                out.append(got.pop(0) if is_t and got else None)
            return tuple(out)

    _Function.__name__ = cls.__name__
    cls._torch_function = _Function
    return _Function


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)
