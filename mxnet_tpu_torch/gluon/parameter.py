"""Gluon ``Parameter`` and ``ParameterDict`` as thin views over
``torch.nn.Parameter``.

Port of the training half of ``mxnet_tpu/gluon/parameter.py``. A layer
of the port owns its weights as ``nn.Parameter`` attributes (made with
their full shapes at construction: no deferred initialization, one
device, no per-context replicas). :meth:`~.block.Block.collect_params`
wraps each in a :class:`Parameter` carrying the Gluon name and the
training attributes MXNet keeps on it: ``grad_req`` (``"write"``
overwrites the gradient on each backward, ``"add"`` accumulates,
``"null"`` takes none; see ``autograd``), ``lr_mult`` and ``wd_mult``.
The view is made once per tensor and kept on it, so settings made
through one ``collect_params()`` hold in the next.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd
from ..base import MXNetError

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """Gluon view of one ``nn.Parameter`` (module docstring)."""

    def __init__(self, name, tensor, lr_mult=1.0, wd_mult=1.0):
        self.name = name
        self._tensor = tensor
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult

    @classmethod
    def of(cls, name, tensor):
        """The view of ``tensor``, made on first use."""
        view = getattr(tensor, "_mx_param", None)
        if view is None:
            view = cls(name, tensor)
            tensor._mx_param = view
        return view

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def grad_req(self):
        return getattr(self._tensor, "_mx_grad_req", "write")

    @grad_req.setter
    def grad_req(self, req):
        autograd.set_grad_req(self._tensor, req)

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self):
        return self._tensor.dtype

    def data(self):
        """The parameter tensor itself (writes to it are the weight's)."""
        return self._tensor

    def grad(self):
        """The gradient tensor; zeros before the first backward (MXNet
        allocates it with the weight). Raises for ``grad_req='null'``."""
        if self.grad_req == "null":
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"'{self.name}' because grad_req='null'")
        if self._tensor.grad is None:
            self._tensor.grad = torch.zeros_like(self._tensor)
        return self._tensor.grad

    def zero_grad(self):
        if self._tensor.grad is not None:
            self._tensor.grad.zero_()

    @torch.no_grad()
    def set_data(self, data):
        """Copy ``data`` (tensor or array of the same shape) into the
        weight."""
        src = torch.as_tensor(data)
        if tuple(src.shape) != self.shape:
            raise ValueError(f"Parameter '{self.name}': shape "
                             f"{tuple(src.shape)}, want {self.shape}")
        self._tensor.copy_(src)


class ParameterDict:
    """Ordered ``{name: Parameter}`` (the port's names carry no model
    prefix: ``embed_word_weight``, ``enc_layer0_attn_qkv_weight``)."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._params = OrderedDict(params or ())

    def __repr__(self):
        body = "\n".join(f"  {v}" for v in self._params.values())
        return f"{type(self).__name__} '{self._prefix}' (\n{body}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        """Set one attribute (``grad_req``, ``lr_mult``, ...) on every
        parameter."""
        for v in self.values():
            setattr(v, name, value)
