"""Recurrent cells: the step-at-a-time API (``cell(x_t, states)``) and
``unroll``.

Port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RecurrentCell``,
``HybridRecurrentCell``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``DropoutCell``, ``ModifierCell``,
``ZoneoutCell``, ``ResidualCell`` and ``BidirectionalCell``. The
cells' ``hybrid_forward`` bodies are the JAX package's in F-ops (``F``
is ``mx.nd``, the arguments plain tensors), and the parameters keep
the JAX names (``i2h_weight`` (G*H, I), ``h2h_weight``, ``i2h_bias``,
``h2h_bias``), so weights carry by name between the packages. A cell
made without ``input_size`` takes its width at the first step
(``infer_shape``). ``unroll`` is a Python loop over the steps, as in
the JAX package; the fused layers (``rnn_layer``) are the fast path.
Dropout and zoneout masks draw from torch's generator of the device
(``mx.random.seed``), not the JAX key chain.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["BidirectionalCell", "DropoutCell", "GRUCell",
           "HybridRecurrentCell", "LSTMCell", "ModifierCell", "RNNCell",
           "RecurrentCell", "ResidualCell", "SequentialRNNCell",
           "ZoneoutCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """``inputs`` (one array with a time axis, or a list of steps) as a
    list of steps (``merge`` False) or one array (``merge`` True);
    returns ``(inputs, time axis, batch size, length)``."""
    if inputs is None:
        raise ValueError("unroll needs inputs")
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, torch.Tensor):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                length = inputs.shape[in_axis]
            inputs = nd.split(inputs, num_outputs=inputs.shape[in_axis],
                              axis=in_axis, squeeze_axis=True)
            if not isinstance(inputs, list):
                inputs = [inputs]
    else:
        if length is not None and len(inputs) != length:
            raise ValueError(f"unroll of {length} steps given "
                             f"{len(inputs)} inputs")
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = nd.stack(*inputs, axis=axis)
    length = len(inputs) if isinstance(inputs, list) \
        else inputs.shape[axis]
    return inputs, axis, batch_size, length


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state``, ``unroll``
    and the step counters."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters (before each ``unroll``)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape=..., name=..., **kwargs)``
        for each of :meth:`state_info`, by default ``nd.zeros``."""
        if self._modified:
            raise MXNetError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.pop("__layout__", None)
            info.update(kwargs)
            states.append(func(
                name=f"{self.prefix}begin_state_{self._init_counter}",
                **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (one array in ``layout``
        or a list of steps); returns ``(outputs, states)``, the outputs
        one array along the time axis with ``merge_outputs``, else a
        list. ``valid_length`` takes each sample's state at its last
        valid step."""
        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size,
                                           ctx=inputs[0].device,
                                           dtype=inputs[0].dtype)
        states = begin_state
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    """A cell whose step is a ``hybrid_forward``."""

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The four parameters of a cell of ``gates`` gates."""

    _GATES = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._GATES * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._GATES * self._hidden_size,
                                 x.shape[-1])


class RNNCell(_GatedCell):
    """Elman cell: ``h' = activation(x W_i2h^T + b_i2h + h W_h2h^T +
    b_h2h)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates (i, f, g, o); states ``[h, c]``."""

    _GATES = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.split(gates, num_outputs=4, axis=1)
        rec = self._recurrent_activation
        in_gate = self._get_activation(F, slice_gates[0], rec)
        forget_gate = self._get_activation(F, slice_gates[1], rec)
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation)
        out_gate = self._get_activation(F, slice_gates[3], rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c,
                                                 self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates (r, z, n): ``n = tanh(x_n + r * (W_hn h +
    b_hn))``, ``h' = (1 - z) * n + z * h``."""

    _GATES = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step goes through them in order, the states
    are theirs concatenated."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self.children(), batch_size=batch_size,
                                  **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self.children():
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("a BidirectionalCell in a "
                                 "SequentialRNNCell cannot be stepped")
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __getitem__(self, i):
        return list(self.children())[i]

    def __len__(self):
        return len(self._modules)

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout of the step's input (in training), no states."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not isinstance(rate, float):
            raise TypeError(f"rate must be a float, got {rate!r}")
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell wrapping ``base_cell`` (whose parameters it shares); the
    base cell cannot be stepped on its own after."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise MXNetError(f"Cell {base_cell.name} is already modified. "
                             f"One cell cannot be modified twice")
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout: in training each output and state unit keeps its
    previous value with probability ``zoneout_outputs`` /
    ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("ZoneoutCell cannot wrap a BidirectionalCell")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, outputs
    concatenated; ``unroll`` only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use "
                         "unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        if self._modified:
            raise MXNetError("After applying modifier cells the base cell "
                             "cannot be called directly.")
        return _cells_begin_state(self.children(), batch_size=batch_size,
                                  **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=inputs[0].device,
                                           dtype=inputs[0].dtype)
        states = begin_state
        l_cell, r_cell = self.children()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
