"""Training callbacks for `hapi.Model.fit` (counterpart of
paddle_tpu/hapi/callbacks.py; reference python/paddle/hapi/callbacks.py:
Callback, ProgBarLogger, ModelCheckpoint, LRScheduler, EarlyStopping,
ReduceLROnPlateau).

Callbacks observe on the host, between steps.
"""
import sys
import time

import numpy as np

__all__ = [
    "Callback",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "ReduceLROnPlateau",
]


class Callback:
    """Base class. Subclasses override the hooks they need."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = dict(params or {})

    def set_model(self, model):
        self.model = model

    # -- lifecycle hooks ------------------------------------------------
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def dispatch(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return dispatch


class ProgBarLogger(Callback):
    """Per-epoch progress line with running loss/metrics and steps/sec.

    verbose=0 silent, 1 one line per epoch, 2 one line per log_freq steps.

    Step timing comes from the shared ``profiler.benchmark()`` meter
    (armed per epoch if nobody else owns it): `jit.TrainStep` ticks the
    meter itself, a loop without one is ticked here — either way the
    steps/s this bar prints, ``benchmark().summary()`` and the
    registry's ``pt_step_batch_cost_seconds`` report the same numbers.
    """

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._own_meter = False

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if k in ("batch_size",):
                continue
            if isinstance(v, (list, tuple, np.ndarray)):
                v = np.asarray(v).reshape(-1)
                parts.append("%s: %s" % (k, ", ".join("%.4f" % x for x in v)))
            elif isinstance(v, float):
                parts.append("%s: %.4f" % (k, v))
            else:
                parts.append("%s: %s" % (k, v))
        return " - ".join(parts)

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def _meter(self):
        from ..profiler import benchmark

        return benchmark()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        self._seen = 0
        bm = self._meter()
        self._own_meter = not bm.enabled
        if self._own_meter:
            bm.enable()
            bm.step()           # arm the first interval
        if self.verbose and self.epochs:
            print("Epoch %d/%d" % (epoch + 1, self.epochs), file=sys.stderr)

    def on_train_batch_end(self, step, logs=None):
        self._seen = step + 1
        bm = self._meter()
        if bm.enabled and not bm.auto_fed:
            # no TrainStep ticks the meter (auto=False: this host-side
            # tick must not claim the auto-fed flag, or it would lock
            # itself out next batch)
            bm.auto_step(num_samples=(logs or {}).get("batch_size"),
                         auto=False)
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            s = bm.stats() if bm.enabled else {}
            ips = s.get("steps_per_sec") or (
                self._seen / max(time.time() - self._t0, 1e-9))
            total = self.steps if self.steps is not None else "?"
            print("step %s/%s - %s - %.1f step/s"
                  % (step + 1, total, self._fmt(logs), ips), file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self._own_meter:
            self._meter().disable()
            self._own_meter = False
        if self.verbose:
            dt = time.time() - self._t0
            print("Epoch %d done in %.1fs - %s"
                  % (epoch + 1, dt, self._fmt(logs)), file=sys.stderr)

    def on_eval_end(self, logs=None):
        if self.verbose:
            print("Eval - %s" % self._fmt(logs), file=sys.stderr)


class ModelCheckpoint(Callback):
    """Save model + optimizer state every `save_freq` epochs and at the end.

    `Model.save` writes `<dir>/<epoch>.pdparams` / `.pdopt` and
    `<dir>/final.*`.
    """

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = "%s/%d" % (self.save_dir, epoch)
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save("%s/final" % self.save_dir)


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler.

    by_step=True steps every batch, else every epoch (reference semantics).
    """

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step and not by_epoch

    def _sched(self):
        from ..optimizer import lr as lr_mod

        opt = getattr(self.model, "_optimizer", None)
        s = getattr(opt, "_learning_rate", None)
        return s if isinstance(s, lr_mod.LRScheduler) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


def _to_scalar(v):
    v = np.asarray(v).reshape(-1)
    return float(v[0])


class EarlyStopping(Callback):
    """Stop training when `monitor` stops improving.

    mode: 'auto'|'min'|'max'. Reference: hapi/callbacks.py EarlyStopping.
    """

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = _to_scalar(logs[self.monitor])
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save("%s/best_model" % self.params["save_dir"])
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print("Early stopping: %s did not improve for %d evals"
                          % (self.monitor, self.wait), file=sys.stderr)


class ReduceLROnPlateau(Callback):
    """Multiply LR by `factor` after `patience` evals without improvement."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = np.inf if self.mode == "min" else -np.inf

    def _better(self, cur):
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = _to_scalar(logs[self.monitor])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(cur):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                from ..optimizer import lr as lr_mod

                opt = self.model._optimizer
                if isinstance(getattr(opt, "_learning_rate", None),
                              lr_mod.LRScheduler):
                    if self.verbose:
                        print("ReduceLROnPlateau: optimizer uses an "
                              "LRScheduler; skipping lr reduction",
                              file=sys.stderr)
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
                    return
                old = opt.get_lr()
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    opt.set_lr(new)
                    if self.verbose:
                        print("ReduceLROnPlateau: lr %.2e -> %.2e"
                              % (old, new), file=sys.stderr)
                self.cooldown_counter = self.cooldown
                self.wait = 0
