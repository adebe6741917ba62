"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

Flags are plain Python values, seeded from `FLAGS_<name>` environment
variables when defined, read with `get_flags` and set at run time with
`set_flags`, which runs the callbacks `on_flag_change` registered for
the flag.
"""
import os
import threading

__all__ = ["define_flag", "get_flags", "set_flags", "get_flag",
           "on_flag_change"]

_lock = threading.Lock()
_registry = {}
_hooks = {}


def on_flag_change(name, fn):
    """Run fn(new_value) whenever `name` is set through set_flags."""
    _hooks.setdefault(name, []).append(fn)


class _FlagInfo:
    __slots__ = ("name", "default", "value", "doc", "type")

    def __init__(self, name, default, doc):
        self.name = name
        self.default = default
        self.value = default
        self.doc = doc
        self.type = type(default)


def _coerce(ty, raw):
    if ty is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return ty(raw)


def define_flag(name, default, doc=""):
    with _lock:
        if name in _registry:
            return _registry[name].value
        info = _FlagInfo(name, default, doc)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            info.value = _coerce(info.type, env)
        _registry[name] = info
        return info.value


def get_flags(names=None):
    if names is None:
        names = list(_registry)
    if isinstance(names, str):
        names = [names]
    return {n: _registry[n].value for n in names if n in _registry}


def set_flags(flags):
    changed = []
    with _lock:
        for name, value in flags.items():
            name = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
            if name not in _registry:
                _registry[name] = _FlagInfo(name, value, "")
                changed.append((name, value))
            else:
                info = _registry[name]
                info.value = _coerce(info.type, value)
                changed.append((name, info.value))
    for name, value in changed:
        for fn in _hooks.get(name, ()):
            fn(value)


def get_flag(name):
    return _registry[name].value if name in _registry else None


define_flag("check_nan_inf", False, "scan op outputs for NaN/Inf (debug)")
define_flag("allocator_strategy", "auto_growth",
            "device memory: torch's caching allocator")
define_flag("eager_delete_tensor_gb", 0.0,
            "no-op: the caching allocator owns buffers")
define_flag("log_level", 0, "verbose log level (VLOG equivalent)")
