"""Serving and deployment (counterpart of paddle_tpu/inference).

The deployment predictor API (reference: python/paddle/inference
exports; C++ AnalysisPredictor analysis_predictor.cc, Config
paddle_analysis_config.h, handle-based IO paddle_inference_api.h:53):
`create_predictor(Config(prefix))` loads a `jit.save` artifact
(`<prefix>.pt2` + `<prefix>.pdiparams`), places its weights on the
configured device — the card unless `disable_gpu()` — and runs it by
handles (`copy_from_cpu` / `run` / `copy_to_cpu`). Inputs are named
`x0 … x{n-1}`, outputs `output_{i}`; a bf16 output is copied out as
f32. A precision knob that disagrees with the artifact warns and runs
as exported: `convert_to_mixed_precision` writes an artifact whose
parameters are stored in bf16 (or f16) and cast up at the program's
boundary. A `PredictorPool` shares one loaded program and one set of
weights on the device among its members.
"""
import warnings

import numpy as np
import torch

from .llm_engine import (LLMEngine, LLMEngineConfig, LLMServer,  # noqa: F401
                         PagePool, PoolExhausted)
from . import fleet_serving  # noqa: F401,E402
from .fleet_serving import (  # noqa: F401,E402
    AutoscalePolicy, FleetRouter, KVPagePayload, LocalReplica,
    OverloadPolicy, Priority, RadixPrefixCache, ReplicaRegistry,
    KVTierStore, RequestCancelled, RequestShed, SLAPolicy, SLAScheduler)
from .serving import BatchingConfig, InferenceServer  # noqa: F401,E402
from .serving import _host  # noqa: E402
from .speculative import SpeculativeDecoder  # noqa: F401,E402
from ..jit import load as _jit_load  # noqa: E402

__all__ = ["LLMEngine", "LLMEngineConfig", "LLMServer", "PagePool",
           "PoolExhausted", "fleet_serving", "RadixPrefixCache",
           "SLAPolicy", "SLAScheduler", "Priority", "FleetRouter",
           "AutoscalePolicy", "LocalReplica", "ReplicaRegistry",
           "KVPagePayload", "OverloadPolicy", "RequestShed",
           "RequestCancelled", "KVTierStore", "BatchingConfig",
           "InferenceServer", "SpeculativeDecoder", "Config", "Predictor",
           "create_predictor", "PredictorPool", "InferTensor", "DataType",
           "PlaceType", "PrecisionType", "get_version",
           "get_num_bytes_of_data_type", "convert_to_mixed_precision"]


class DataType:
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    INT8 = "int8"
    BOOL = "bool"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    XPU = "xpu"


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


def get_version():
    import paddle_tpu_torch

    return getattr(paddle_tpu_torch, "__version__", "0.0")


def get_num_bytes_of_data_type(dtype):
    from ..core.dtype import convert_dtype

    return convert_dtype(str(dtype)).itemsize


class Config:
    """reference paddle_analysis_config.h AnalysisConfig. The device and
    precision knobs are honored; the pass-pipeline knobs have nothing to
    configure and are kept for the reference's surface, as are the XLA
    compile options (stored, reaching no compiler here)."""

    def __init__(self, prog_file=None, params_file=None):
        # one prefix names <prefix>.pt2 + <prefix>.pdiparams
        self.model_path = prog_file
        self._device = "gpu"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._profile = False
        self._compiler_options = {}

    def set_xla_compile_option(self, key, value):
        self._compiler_options[str(key)] = value
        return self

    def xla_compile_options(self):
        return dict(self._compiler_options)

    # -- device selection --
    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self._device, self._device_id = "gpu", int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def enable_xpu(self, *a, **k):
        self._device = "gpu"

    def set_cpu_math_library_num_threads(self, n):
        pass

    def use_gpu(self):
        return self._device != "cpu"

    def gpu_device_id(self):
        return self._device_id

    # -- precision / optimization --
    def enable_mixed_precision(self, precision=PrecisionType.Bfloat16):
        self._precision = precision

    def switch_ir_optim(self, flag=True):
        pass

    def enable_memory_optim(self, flag=True):
        pass

    def enable_profile(self):
        self._profile = True

    def summary(self):
        return (f"Config(model={self.model_path}, device={self._device}:"
                f"{self._device_id}, precision={self._precision})")


class InferTensor:
    """Handle-based IO tensor (reference paddle_inference_api.h Tensor:
    copy_from_cpu / copy_to_cpu / reshape / shape)."""

    def __init__(self, name):
        self.name = name
        self._data = None

    def reshape(self, shape):
        if self._data is not None:
            self._data = np.reshape(self._data, shape)
        else:
            self._data = np.zeros(shape, np.float32)

    def copy_from_cpu(self, arr):
        # the name is the contract: a copy, not an alias of the caller's
        # buffer
        self._data = np.array(arr)

    def copy_to_cpu(self):
        return np.asarray(self._data)

    def shape(self):
        return list(np.shape(self._data))


class Predictor:
    """reference analysis_predictor.cc Predictor: named handles + run()."""

    def __init__(self, config, _shared_layer=None):
        self.config = config
        if config.model_path is None:
            raise ValueError("Config needs the saved-model path prefix")
        self._device = self._pick_device()
        self._layer = (_shared_layer if _shared_layer is not None
                       else _jit_load(config.model_path, device=self._device))
        n_in = getattr(self._layer, "_n_inputs", None) or 1
        self._in_names = [f"x{i}" for i in range(n_in)]
        self._inputs = {n: InferTensor(n) for n in self._in_names}
        self._outputs = {}
        self._place_params()
        if getattr(config, "_compiler_options", None):
            self._layer.set_compiler_options(config._compiler_options)

    def _pick_device(self):
        from ..core.place import resolve_device

        if self.config._device == "cpu":
            return torch.device("cpu")
        dev = resolve_device("cuda")   # raises where no GPU is present
        count = torch.cuda.device_count()
        return torch.device(dev.type,
                            min(self.config._device_id, count - 1))

    def _place_params(self):
        # dtypes are baked into the exported program; a precision knob
        # that disagrees with the artifact cannot be honored here — use
        # convert_to_mixed_precision on the files
        if self.config._precision != PrecisionType.Float32:
            want = str(self.config._precision)
            have = {str(v.dtype).replace("torch.", "")
                    for v in self._layer._param_vals
                    if v.is_floating_point()}
            if have - {want}:
                warnings.warn(
                    f"artifact was exported with param dtypes {have}; "
                    f"requested {want} — running as exported. Re-save "
                    "with convert_to_mixed_precision for bf16 storage.",
                    RuntimeWarning)
        self._layer._place(self._device)

    # -- reference API --
    def get_input_names(self):
        return list(self._in_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return list(self._outputs) or ["output_0"]

    def get_output_handle(self, name):
        return self._outputs.setdefault(name, InferTensor(name))

    def run(self, inputs=None):
        """Handle-based (no args) or direct (a list of arrays): the
        outputs as host arrays."""
        if inputs is None:
            inputs = [self._inputs[n].copy_to_cpu() for n in self._in_names]
        arrs = [torch.as_tensor(np.asarray(x)).to(self._device)
                for x in inputs]
        out = self._layer(*arrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        host = [_host(o) for o in outs]
        for i, h in enumerate(host):
            self.get_output_handle(f"output_{i}")._data = h
        return host

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config):
    return Predictor(config)


class PredictorPool:
    """N predictors over ONE loaded artifact (reference PredictorPool):
    the program and the device-placed weights are shared — pool members
    differ only in their IO handles."""

    def __init__(self, config, size=1):
        first = Predictor(config)
        self._preds = [first] + [
            Predictor(config, _shared_layer=first._layer)
            for _ in range(size - 1)]

    def retrieve(self, idx):
        return self._preds[idx]


class _UpCast(torch.nn.Module):
    """The loaded program with its parameters cast up to the dtypes it
    was exported with."""

    def __init__(self, program, dtypes):
        super().__init__()
        object.__setattr__(self, "_program", program)
        self._dtypes = list(dtypes)

    def forward(self, params, *xs):
        up = tuple(p.to(d) if p.is_floating_point() else p
                   for p, d in zip(params, self._dtypes))
        return self._program(up, *xs)


def convert_to_mixed_precision(src_prefix, dst_prefix,
                               mixed_precision=PrecisionType.Bfloat16,
                               backend=None, **kw):
    """Re-export a jit.save artifact with its floating parameters STORED
    in the mixed dtype (reference convert_to_mixed_precision tool): the
    new program casts them up at its boundary, so weight storage and
    transfer halve while the computation is the exported one."""
    from ..framework.io_state import save as t_save
    from ..jit import _export, _np_param

    if mixed_precision == PrecisionType.Int8:
        raise NotImplementedError(
            "int8 needs calibration scales, not a dtype cast — use "
            "paddle_tpu_torch.quantization")
    layer = _jit_load(src_prefix, device="cpu")
    cast = {PrecisionType.Bfloat16: torch.bfloat16,
            PrecisionType.Half: torch.float16}.get(mixed_precision)
    if cast is None:
        raise ValueError(f"unknown mixed precision {mixed_precision!r}")
    orig = [v.dtype for v in layer._param_vals]
    stored = tuple(v.to(cast) if v.is_floating_point() else v
                   for v in layer._param_vals)
    from ..core.dtype import convert_dtype

    xs = [torch.zeros(shape, dtype=convert_dtype(dt))
          for shape, dt in layer._input_specs]
    _export(_UpCast(layer._program, orig), (stored, *xs), dst_prefix)
    packed = [_np_param(v) for v in stored]
    t_save({"names": layer._names, "params": [a for a, _ in packed],
            "dtypes": [t for _, t in packed],
            "n_inputs": layer._n_inputs,
            "input_specs": layer._input_specs},
           dst_prefix + ".pdiparams")
