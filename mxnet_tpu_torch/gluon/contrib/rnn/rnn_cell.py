"""Contrib recurrent cells: ``VariationalDropoutCell``.

Port of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``: the JAX cell's
``hybrid_forward`` in F-ops. Its masks draw from torch's generator of
the device (``mx.random.seed``), not the JAX key chain.
"""
from __future__ import annotations

from ...rnn.rnn_cell import BidirectionalCell, ModifierCell
from ....base import MXNetError

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """Dropout with one mask for every step of an unroll (Gal and
    Ghahramani): of the inputs, of the first state and of the outputs.
    The masks are drawn at the first step after :meth:`reset`."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise MXNetError("drop_states cannot apply to a "
                             "BidirectionalCell")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_mask(self, F, p, like):
        return F.Dropout(F.ones_like(like), p=p)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        if self.drop_states:
            if self.drop_states_mask is None:
                self.drop_states_mask = self._initialize_mask(
                    F, self.drop_states, states[0])
            states = [states[0] * self.drop_states_mask] + list(states[1:])
        if self.drop_inputs:
            if self.drop_inputs_mask is None:
                self.drop_inputs_mask = self._initialize_mask(
                    F, self.drop_inputs, inputs)
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = cell(inputs, states)
        if self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = self._initialize_mask(
                    F, self.drop_outputs, next_output)
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states
