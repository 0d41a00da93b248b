"""Fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU`` over the ``RNN``
op.

Port of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (``_RNNLayer``, ``RNN``,
``LSTM``, ``GRU``). Parameters carry the reference's names and shapes,
``{l,r}{i}_{i2h,h2h}_{weight,bias}`` with ``i2h_weight`` (G*H, I) and
``h2h_weight`` (G*H, H), G the mode's gates (4, 3 or 1), so
``Block.load_gluon_params`` takes the JAX layer's ``collect_params`` as
they are. Layouts ``TNC`` and ``NTC``; called without states the layer
starts from zeros and returns the output only, with states it returns
``(output, [h, c])`` (LSTM) or ``(output, [h])``. The LSTM runs on the
K6 kernels, GRU and vanilla RNN on torch's (cuDNN's) recurrences (see
``ndarray.op_impl_rnn``). ``LSTM(projection_size=...)`` raises: the
JAX layer accepts and ignores it.

Without ``input_size`` the first layer's ``i2h_weight`` (both
directions') takes its width at the first forward (a deferred shape,
``gluon.parameter``). :meth:`begin_state` gives NDArrays, as the
reference's, on ``ctx`` (default: the layer's device). The JAX layer
packs every weight into one flat vector each forward
(``_flat_params``); here the layer hands its per-layer tensors to
``ndarray.op_impl_rnn.rnn_layers`` directly, which saves that copy and
its backward (the packed ``rnn`` op is still there). Dropout between
layers follows ``autograd.is_training()``. A Symbol raises
``MXNetError`` naming the layer: the fused layer has no symbolic form
(nor has the JAX one, whose trace needs states and their shapes).
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import MXNetError
from ...context import resolve_device
from ...ndarray import op_impl_rnn
from ...ndarray.ndarray import NDArray, as_nd
from ...ndarray.register import amp_cast
from ..block import HybridBlock

__all__ = ["GRU", "LSTM", "RNN"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, dtype="float32", prefix=None,
                 params=None, device=None):
        super().__init__(prefix, params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"Invalid layout {layout}; must be one of "
                             f"['TNC' or 'NTC']")
        op_impl_rnn._check_mode(mode)
        dev = resolve_device(device)
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng = op_impl_rnn._GATES[mode]
        ni, nh = input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                for name, shape, init in (
                        ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                        ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                    setattr(self, f"{j}{i}_{name}",
                            self._param(shape, dt, dev, init=init))
            ni = nh * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Initial states of the state_info shapes: ``func(shape,
        **kwargs)``, by default NDArray zeros on ``ctx`` (a context or
        device; default the layer's). ``kwargs`` (``dtype``, ...) go to
        ``func``; a ``device`` among them stands for ``ctx``."""
        dev = self.l0_h2h_weight.device \
            if ctx is None and "device" not in kwargs \
            else resolve_device(kwargs.pop("device", ctx))
        if func is None:
            dtype = kwargs.pop("dtype", None) or torch.float32
            return [as_nd(torch.zeros(info["shape"], dtype=dtype,
                                      device=dev))
                    for info in self.state_info(batch_size)]
        return [func(info["shape"], device=dev, **kwargs)
                for info in self.state_info(batch_size)]

    def layer_params(self):
        """``[(w_i2h, w_h2h, b_i2h, b_h2h)]`` per (layer, direction),
        layer-major: the order of the packed layout."""
        return [tuple(getattr(self, f"{j}{i}_{name}")
                      for name in ("i2h_weight", "h2h_weight", "i2h_bias",
                                   "h2h_bias"))
                for i in range(self._num_layers)
                for j in ["l", "r"][:self._dir]]

    def forward(self, inputs, states=None):
        if self._deferred:
            ng = op_impl_rnn._GATES[self._mode]
            self._input_size = inputs.shape[2]
            self._finish_deferred(**{
                f"{j}0_i2h_weight": (ng * self._hidden_size,
                                     self._input_size)
                for j in ["l", "r"][:self._dir]})
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.find("N")]
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(batch)]
        if isinstance(states, torch.Tensor):
            states = [states]
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        lstm = self._mode == "lstm"
        # the tensors as the RNN op takes them (under AMP: all in the
        # half type, the weights of every layer included)
        inputs, h0, c0, *flat = amp_cast(
            "RNN", inputs, states[0], states[1] if lstm else None,
            *(w for layer in self.layer_params() for w in layer))
        out, h, c = op_impl_rnn.rnn_layers(
            inputs, [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)],
            h0, c0, self._num_layers, self._dir == 2, self._dropout,
            autograd.is_training(), mode=self._mode)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if lstm else [h])

    def hybrid_forward(self, F, inputs, states=None, **params):
        raise MXNetError(
            f"{type(self).__name__} '{self.name}' has no symbolic form: "
            f"the fused recurrent layer runs on tensors only, and the "
            f"reference layer has none either (the JAX layer cannot trace "
            f"a Symbol); build the graph with mx.sym.RNN or mx.rnn's cells")


class RNN(_RNNLayer):
    """Vanilla (Elman) multi-layer RNN, ``activation`` ``"relu"`` or
    ``"tanh"``. ``device`` as :class:`LSTM`'s."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, dtype="float32", prefix=None, params=None,
                 device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, dtype,
                         prefix, params, device)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Fused multi-layer LSTM (the cuDNN-LSTM analog; the WikiText-2
    word LM's layer). ``device=None`` is the current context's device
    and raises without a card; pass ``device="cpu"`` (or use ``with
    mx.cpu():``) for the CPU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, dtype="float32", prefix=None,
                 params=None, device=None):
        if projection_size is not None:
            raise NotImplementedError(
                "LSTM projection_size is not implemented (the JAX layer "
                "accepts and ignores it, which would give a wrong answer)")
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", dtype, prefix, params,
                         device)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Fused multi-layer GRU (gates r, z, n). ``device`` as
    :class:`LSTM`'s."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", prefix=None, params=None, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", dtype, prefix, params,
                         device)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
