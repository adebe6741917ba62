"""`Model` — the high-level train / eval / predict loop (counterpart of
paddle_tpu/hapi/model.py; reference python/paddle/hapi/model.py:915
Model, :1574 fit, :1802 evaluate, :1946 predict, :2267 summary).

`train_batch` is one `jit.TrainStep` (forward, loss, backward and the
optimizer update); eval and predict run the network under `no_grad`.
Batches move to the network's device (a DataLoader yields CPU tensors).
Train logs carry loss and lr; metrics are computed in `evaluate`, so
logits stay on the card while training. The reference's rules hold:
`update=False` raises, and `amp_configs` is stored and never used, so
`fit` runs in the network's own dtype (ROADMAP C).
"""
import os

import numpy as np
import torch

from ..framework import io_state
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model", "summary"]


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _loader(data, batch_size, shuffle, drop_last, num_workers):
    if data is None or isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)
    return data  # any iterable of batches


def _host(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Model:
    """Wraps a `nn.Layer` with `fit` / `evaluate` / `predict` / `save` /
    `load`.

    `inputs` / `labels` (optional lists of input specs) fix how a batch
    splits into forward inputs and loss labels; without them a batch of
    N elements splits as N-1 inputs + 1 label, and a 1-element batch is
    all inputs.
    """

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _as_list(inputs)
        self._labels = _as_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self.stop_training = False

    # -- setup ----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a callable (Layer or function)")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError("metrics must be Metric instances, got %r"
                                % (m,))
        self._amp_configs = amp_configs
        self._train_step = None  # rebuilt with the new optimizer and loss

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def _device(self):
        for p in self.network.parameters():
            return p.device
        return torch.device("cpu")

    def _to_device(self, xs):
        dev = self._device()
        return [x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev)
                for x in xs]

    # -- batch split ----------------------------------------------------
    def _split_batch(self, batch):
        batch = _as_list(batch)
        if self._inputs:
            n_in = len(self._inputs)
        elif len(batch) == 1:
            n_in = 1
        else:
            n_in = len(batch) - max(len(self._labels), 1)
            n_in = max(n_in, 1)
        return batch[:n_in], batch[n_in:]

    # -- single-batch entry points --------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step; returns [the scalar loss (float)]."""
        if self._loss is None or self._optimizer is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch/fit")
        if not update:
            raise NotImplementedError(
                "update=False (gradient accumulation) is not supported: the "
                "train step fuses backward+update; use a larger batch or "
                "DistributedTrainStep(accumulate_steps=...)")
        inputs = _as_list(inputs)
        labels = _as_list(labels)
        if self._train_step is None:
            from ..jit import TrainStep

            n_in = len(inputs)
            loss_layer = self._loss

            def loss_fn(network, *batch):
                outs = network(*batch[:n_in])
                outs = outs if isinstance(outs, (list, tuple)) else [outs]
                return loss_layer(*outs, *batch[n_in:])

            self.network.train()
            self._train_step = TrainStep(self.network, loss_fn,
                                         self._optimizer)
            self._train_arity = (n_in, len(labels))
        if (len(inputs), len(labels)) != self._train_arity:
            raise ValueError("train_batch arity changed (%s vs %s)"
                             % ((len(inputs), len(labels)),
                                self._train_arity))
        loss = self._train_step(*inputs, *labels)
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """Forward + metric update; returns (loss_list, metric_results)."""
        self.network.eval()
        inputs = self._to_device(_as_list(inputs))
        labels = self._to_device(_as_list(labels))
        outs = self.network(*inputs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        losses = []
        if self._loss is not None and labels:
            losses = [float(self._loss(*outs, *labels))]
        res = {}
        for m in self._metrics:
            stats = m.compute(*outs, *labels)
            stats = stats if isinstance(stats, (list, tuple)) else [stats]
            m.update(*[_host(s) if isinstance(s, torch.Tensor)
                       else np.asarray(s) for s in stats])
            res.update(zip(_as_list(m.name()), _as_list(m.accumulate())))
        return losses, res

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._to_device(_as_list(inputs))
        outs = self.network(*inputs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return [_host(o) for o in outs]

    # -- loops ----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        loader = _loader(train_data, batch_size, shuffle, drop_last,
                         num_workers)
        eval_loader = _loader(eval_data, batch_size, False, False,
                              num_workers)
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose)]
                            + _as_list(callbacks)
                            + ([ModelCheckpoint(save_freq, save_dir)]
                               if save_dir else []))
        cbks.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose, "save_dir": save_dir})
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            self.network.train()
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                losses = self.train_batch(ins, labs)
                logs = {"loss": losses, "lr": self._optimizer.get_lr(),
                        "batch_size": batch_size}
                cbks.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks, log_freq)
                logs.update({"eval_" + k if not k.startswith("eval_") else k:
                             v for k, v in eval_logs.items()})
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        return logs

    def _run_eval(self, loader, cbks, log_freq):
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        self.network.eval()
        loss_sum, n, res = 0.0, 0, {}
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            losses, res = self.eval_batch(ins, labs)
            if losses:
                loss_sum += losses[0]
                n += 1
            cbks.on_eval_batch_end(step, {"loss": losses, **res})
        logs = dict(res)
        if n:
            logs["loss"] = loss_sum / n
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = _loader(eval_data, batch_size, False, False, num_workers)
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose)]
                            + _as_list(callbacks))
        cbks.set_model(self)
        cbks.set_params({"verbose": verbose})
        return self._run_eval(loader, cbks, log_freq)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = _loader(test_data, batch_size, False, False, num_workers)
        cbks = CallbackList(_as_list(callbacks))
        cbks.set_model(self)
        cbks.set_params({"verbose": verbose})
        cbks.on_predict_begin()
        outputs = None
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins, _ = self._split_batch(batch)
            outs = self.predict_batch(ins)
            if outputs is None:
                outputs = [[] for _ in outs]
            for slot, o in zip(outputs, outs):
                slot.append(o)
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        if outputs is None:
            return []
        if stack_outputs:
            outputs = [np.concatenate(slot, axis=0) for slot in outputs]
        return outputs

    # -- persistence ----------------------------------------------------
    def save(self, path, training=True):
        """`path + '.pdparams'` (+ `.pdopt` when training=True), through
        `framework.io_state`: files the reference's `Model.load` reads,
        and the port's reads the reference's."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        io_state.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            io_state.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        params = io_state.load(path + ".pdparams")
        try:
            self.network.set_state_dict(params)
        except (KeyError, ValueError):
            if not skip_mismatch:
                raise
        self._train_step = None  # a new step over the restored values
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(io_state.load(opt_path))

    def summary(self, input_size=None, dtype=None):
        return summary(self.network)


def summary(network, input_size=None, dtype=None):
    """Parameter-count table (reference: hapi/model_summary.py:1): the
    parameters' names, shapes and counts; no traced forward."""
    rows = []
    total = 0
    trainable = 0
    for name, p in network.named_parameters():
        n = int(np.prod(tuple(p.shape))) if len(p.shape) else 1
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows] + [10])
    lines = ["%-*s  %-20s  %s" % (width, "Param", "Shape", "Count")]
    lines += ["%-*s  %-20s  %d" % (width, n, s, c) for n, s, c in rows]
    lines.append("Total params: %d" % total)
    lines.append("Trainable params: %d" % trainable)
    lines.append("Non-trainable params: %d" % (total - trainable))
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
