"""Symbolic RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``, MXNet's
``python/mxnet/rnn/rnn_cell.py``).

Each cell's ``__call__(inputs, states) -> (output, next_states)``
composes Symbol ops (FullyConnected, Activation, elementwise), and
``unroll`` builds the length-T graph, which the executor binds as one
computation per bucket length (on the card one pair of CUDA graphs),
as ``BucketingModule`` pairs with it upstream. ``begin_state`` and the
default zero states of ``unroll`` are the JAX package's: the zeros are
built from the step input, so a graph infers its shapes forward.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ResidualCell", "BidirectionalCell"]


class RNNParams:
    """Container sharing weight Symbols across time steps (reference
    rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell: subclasses define state_info and __call__."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self.params = params if params is not None else RNNParams(prefix)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    def begin_state(self, func=None, batch_size=None, **kwargs):
        """Initial state symbols.

        Default (func=None): free Variables — bind them with concrete
        shapes. With ``func`` (e.g. ``mx.sym.zeros``): the reference
        leaves batch as 0 and relies on nnvm's bidirectional shape
        inference; the forward-only inference here can't resolve that, so
        pass ``batch_size`` to substitute it (or omit begin_state
        entirely in ``unroll`` — the default builds zeros tied to the
        input's batch dim symbolically)."""
        self._init_counter += 1
        states = []
        for i, info in enumerate(self.state_info):
            name = f"{self._prefix}begin_state_{self._init_counter}_{i}"
            if func is None:
                states.append(sym.Variable(name, **kwargs))
            else:
                info = dict(info)
                shape = tuple(info.pop("shape", ()))
                if batch_size is not None:
                    shape = tuple(batch_size if d == 0 else d for d in shape)
                if any(d == 0 for d in shape):
                    raise MXNetError(
                        "begin_state(func=...) needs a concrete batch: "
                        "pass batch_size=N (the reference resolves the "
                        "0 dim via nnvm bidirectional inference, which "
                        "the forward-only shape inference does not do)")
                info.pop("__layout__", None)
                states.append(func(name=name, shape=shape, **info, **kwargs))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def _normalize_inputs(self, length, inputs, layout):
        """One Symbol (split on the layout's T axis) or a per-step list
        -> validated per-step list (shared by every unroll)."""
        axis = layout.find("T")
        if axis < 0:
            raise MXNetError(f"invalid layout {layout!r}")
        if not isinstance(inputs, (list, tuple)):
            splitted = sym.split(inputs, num_outputs=length, axis=axis,
                                 squeeze_axis=True)
            inputs = [splitted[i] for i in range(length)]
        if len(inputs) != length:
            raise MXNetError(
                f"got {len(inputs)} step inputs, expected {length}")
        return list(inputs)

    def _zero_state_like(self, step_input):
        """Zero initial states derived from one step input symbol
        (keeps the batch dimension symbolically tied to the data)."""
        states = []
        for info in self.state_info:
            h = int(info["shape"][-1])
            states.append(sym.broadcast_to(
                sym.sum(step_input, axis=-1, keepdims=True) * 0.0,
                shape=(0, h)))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell ``length`` steps (reference BaseRNNCell.unroll).

        inputs: one Symbol (sliced along the time axis of ``layout``) or
        a list of per-step Symbols. Returns (outputs, states) where
        outputs is a single concatenated Symbol when merge_outputs else
        the per-step list.
        """
        self.reset()
        axis = layout.find("T")
        inputs = self._normalize_inputs(length, inputs, layout)
        if begin_state is None:
            # default: ZERO states built symbolically FROM the input
            # (batch dim rides along), so the unrolled graph is fully
            # forward-shape-inferable — the reference leaves free
            # variables here and relies on nnvm's bidirectional
            # inference, which the forward shape walk doesn't do. To
            # feed initial states, pass begin_state=cell.begin_state()
            # variables explicitly and bind them with shapes.
            states = self._zero_state_like(inputs[0])
        else:
            states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            outputs.append(out)
        if merge_outputs:
            expanded = [sym.expand_dims(o, axis=axis) for o in outputs]
            return sym.concat(*expanded, dim=axis), states
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh cell (reference rnn_cell.py RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py LSTMCell; gate order i,f,c,o —
    the cuDNN-canonical order the fused RNN op also uses)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        # forget_bias is BAKED INTO the h2h_bias initializer (reference
        # rnn_cell.py: init.LSTMBias), NOT added at runtime — trained
        # checkpoints then interchange with the reference bit-for-bit
        from ..initializer import LSTMBias
        self._hB = self.params.get(
            "h2h_bias", init=LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}h2h")
        gates = i2h + h2h
        sliced = sym.SliceChannel(gates, num_outputs=4, name=f"{name}slice")
        in_gate, forget_gate, in_trans, out_gate = (sliced[i]
                                                    for i in range(4))
        in_gate = sym.Activation(in_gate, act_type="sigmoid")
        forget_gate = sym.Activation(forget_gate, act_type="sigmoid")
        in_trans = sym.Activation(in_trans, act_type="tanh")
        out_gate = sym.Activation(out_gate, act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference rnn_cell.py GRUCell; gate order r,z,n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(inputs, self._iW, self._iB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(states[0], self._hW, self._hB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}h2h")
        si = sym.SliceChannel(i2h, num_outputs=3, name=f"{name}i2h_slice")
        sh = sym.SliceChannel(h2h, num_outputs=3, name=f"{name}h2h_slice")
        i_r, i_z, i_n = (si[i] for i in range(3))
        h_r, h_z, h_n = (sh[i] for i in range(3))
        reset = sym.Activation(i_r + h_r, act_type="sigmoid")
        update = sym.Activation(i_z + h_z, act_type="sigmoid")
        new = sym.Activation(i_n + reset * h_n, act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * new
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence per step (reference
    SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    def reset(self):
        super().reset()
        for c in getattr(self, "_cells", []):
            c.reset()

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, func=None, **kwargs):
        return sum((c.begin_state(func=func, **kwargs)
                    for c in self._cells), [])

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        out = inputs
        for cell in self._cells:
            n = len(cell.state_info)
            out, ns = cell(out, states[pos:pos + n])
            next_states.extend(ns)
            pos += n
        return out, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout between stacked cells (reference DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell._prefix, params=base_cell.params)
        self.base_cell = base_cell

    def reset(self):
        super().reset()
        if hasattr(self, "base_cell"):
            self.base_cell.reset()

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        return self.base_cell.begin_state(func=func, **kwargs)


class ResidualCell(ModifierCell):
    """Adds the step input to the cell output (reference ResidualCell)."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        # delegate so unroll-only wrapped cells (BidirectionalCell)
        # compose, as upstream ResidualCell.unroll does
        self.reset()
        axis = layout.find("T")
        inputs = self._normalize_inputs(length, inputs, layout)
        outputs, states = self.base_cell.unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=False)
        outputs = [o + i for o, i in zip(outputs, inputs)]
        if merge_outputs:
            outputs = sym.concat(*[sym.expand_dims(o, axis=axis)
                                   for o in outputs], dim=axis)
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs one cell forward and one backward over the sequence,
    concatenating per-step outputs (reference BidirectionalCell).
    Stepwise ``__call__`` is undefined for a bidirectional cell — use
    ``unroll`` (the reference raises the same way)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        # params is accepted for reference-signature parity; the wrapped
        # cells own their parameters
        super().__init__(prefix=output_prefix, params=params)
        self._l = l_cell
        self._r = r_cell

    def reset(self):
        super().reset()
        if hasattr(self, "_l"):
            self._l.reset()
            self._r.reset()

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, func=None, **kwargs):
        return (self._l.begin_state(func=func, **kwargs)
                + self._r.begin_state(func=func, **kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        inputs = self._normalize_inputs(length, inputs, layout)
        nl = len(self._l.state_info)
        if begin_state is None:
            l_states = r_states = None
        else:
            l_states, r_states = begin_state[:nl], begin_state[nl:]
        l_out, l_states = self._l.unroll(length, list(inputs),
                                         begin_state=l_states, layout=layout,
                                         merge_outputs=False)
        r_out, r_states = self._r.unroll(length, list(reversed(inputs)),
                                         begin_state=r_states, layout=layout,
                                         merge_outputs=False)
        outputs = [sym.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = sym.concat(*[sym.expand_dims(o, axis=axis)
                                   for o in outputs], dim=axis)
        return outputs, l_states + r_states
