"""Recurrent layers (counterpart of paddle_tpu/nn/layer/rnn.py).

The reference's parameter names (`weight_ih`, `bias_hh` on a cell;
`weight_ih_0`, `weight_hh_0_reverse`, ... on the multi-layer nets) and
shapes ([gates · hidden, in]), so a reference state dict loads key for
key, and its gate orders: LSTM i, f, g, o; GRU r, z, n with
n = tanh(xn + r · hn) and h = (1 - z) · n + z · h. A net's states are
[layers · directions, batch, hidden]; its inter-layer dropout applies
to every layer's output but the last. `sequence_length` is accepted and
ignored, as in the reference: every sequence runs the whole time axis.

The time loop is the port's own (`_run_layer`: the input projections
of all steps in one product, then one small step per time index). On a
CUDA tensor with no dropout in effect a net runs torch's fused RNN
instead (`torch._VF.lstm` / `gru` / `rnn_tanh` / `rnn_relu`, the same
gate orders and weight layout); the reference has no Pallas kernel
here. `net._apply_route(net._loop, inputs)` runs the loop on any
device (for holding the two routes against each other on the card).
"""
import math

import torch

from ...core import rng
from ...core.dtype import convert_dtype
from .. import initializer as I
from .layers import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
    "SimpleRNN", "LSTM", "GRU",
]

def _std_uniform(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


def _act(name):
    return torch.tanh if name == "tanh" else torch.relu


def _lstm_step(xg, h, c, wh, bh):
    gates = xg + h @ wh.T + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_step(xg, h, wh, bh):
    hg = h @ wh.T + bh
    xr, xz, xn = xg.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        kw = dict(dtype=convert_dtype(dtype), device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(torch.full([batch] + list(s), init_value, **kw)
                         for s in shape)
        return torch.full([batch] + list(shape), init_value, **kw)


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        init = _std_uniform(hidden_size)
        g = self.GATES * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, is_bias=True, default_initializer=init)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def _xg(self, inputs):
        return inputs @ self.weight_ih.T + self.bias_ih


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _act(self.activation)(self._xg(inputs) + states
                                  @ self.weight_hh.T + self.bias_hh)
        return h, h


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        h, c = _lstm_step(self._xg(inputs), states[0], states[1],
                          self.weight_hh, self.bias_hh)
        return h, (h, c)


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_step(self._xg(inputs), states, self.weight_hh,
                      self.bias_hh)
        return h, h


class RNN(Layer):
    """Run a cell over the time axis (reversed with is_reverse)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        xs = inputs.unbind(axis)
        if self.is_reverse:
            xs = xs[::-1]
        states, outs = initial_states, []
        for x in xs:
            out, states = self.cell(x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf, sb = (initial_states if initial_states is not None
                  else (None, None))
        of, stf = self.rnn_fw(inputs, sf)
        ob, stb = self.rnn_bw(inputs, sb)
        return torch.cat([of, ob], -1), (stf, stb)


def _run_layer(mode, act, seq, h, c, wi, wh, bi, bh):
    """One direction of one layer over time-major `seq` [T, B, in]:
    (outputs [T, B, H], last h, last c)."""
    xg = seq @ wi.T + bi
    outs = []
    for t in range(seq.shape[0]):
        if mode == "LSTM":
            h, c = _lstm_step(xg[t], h, c, wh, bh)
        elif mode == "GRU":
            h = _gru_step(xg[t], h, wh, bh)
        else:
            h = act(xg[t] + h @ wh.T + bh)
        outs.append(h)
    return torch.stack(outs), h, c


class _RNNBase(Layer):
    """A multi-layer (bi)directional net over the time loop."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        gates = {"RNN": 1, "LSTM": 4, "GRU": 3}[mode] * hidden_size
        init = _std_uniform(hidden_size)
        self._param_names = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = (input_size if layer == 0
                         else hidden_size * self.bidirect)
                sfx = f"_{layer}" + ("_reverse" if d else "")
                names = [f"weight_ih{sfx}", f"weight_hh{sfx}",
                         f"bias_ih{sfx}", f"bias_hh{sfx}"]
                shapes = [[gates, in_sz], [gates, hidden_size], [gates],
                          [gates]]
                attrs = [weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr]
                for n, s, a in zip(names, shapes, attrs):
                    self.add_parameter(n, self.create_parameter(
                        s, a, is_bias="bias" in n, default_initializer=init))
                self._param_names.append(names)

    def _flat_params(self):
        return [getattr(self, n) for names in self._param_names
                for n in names]

    def _fused(self, x, h0, c0):
        args = (self._flat_params(), True, self.num_layers, 0.0,
                self.training, self.bidirect == 2, False)
        if self.mode == "LSTM":
            out, h, c = torch._VF.lstm(x, (h0, c0), *args)
            return out, h, c
        fn = {"GRU": torch._VF.gru, "RNN": torch._VF.rnn_tanh
              if self.activation == "tanh" else torch._VF.rnn_relu}[
                  self.mode]
        out, h = fn(x, h0, *args)
        return out, h, None

    def _dropping(self):
        return self.dropout > 0.0 and self.training and self.num_layers > 1

    def _loop(self, x, h0, c0):
        lstm = self.mode == "LSTM"
        nl, nd = self.num_layers, self.bidirect
        dropping = self._dropping()
        act = _act(self.activation)
        params = self._flat_params()
        layer_in, hs_out, cs_out = x, [], []
        for layer in range(nl):
            outs = []
            for d in range(nd):
                i = layer * nd + d
                seq = layer_in.flip(0) if d else layer_in
                ys, h, c = _run_layer(
                    self.mode, act, seq, h0[i],
                    c0[i] if lstm else None, *params[4 * i:4 * i + 4])
                outs.append(ys.flip(0) if d else ys)
                hs_out.append(h)
                cs_out.append(c)
            layer_in = torch.cat(outs, -1) if nd == 2 else outs[0]
            if dropping and layer < nl - 1:
                gen = (rng.current_generator()
                       or rng.next_generator(layer_in.device))
                keep = torch.rand(layer_in.shape, generator=gen,
                                  device=layer_in.device) >= self.dropout
                layer_in = torch.where(
                    keep, layer_in / (1.0 - self.dropout), 0.0)
        c = torch.stack(cs_out) if lstm else None
        return layer_in, torch.stack(hs_out), c

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fused = inputs.is_cuda and not self._dropping()
        return self._apply_route(self._fused if fused else self._loop,
                                 inputs, initial_states)

    def _apply_route(self, route, inputs, initial_states=None):
        """`route(x, h0, c0)` (`_fused` or `_loop`) over time-major x
        and full initial states, in the layer's own layout."""
        lstm = self.mode == "LSTM"
        x = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is not None:
            h0, c0 = initial_states if lstm else (initial_states, None)
        else:
            h0 = x.new_zeros((self.num_layers * self.bidirect, x.shape[1],
                              self.hidden_size))
            c0 = torch.zeros_like(h0) if lstm else None
        out, h, c = route(x, h0, c0)
        if not self.time_major:
            out = out.transpose(0, 1)
        return (out, (h, c)) if lstm else (out, h)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)
