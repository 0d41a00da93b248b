"""Base of the port's layers: an ``nn.Module`` that carries Gluon's
parameter naming and MXNet's recording rule.

Port of ``mxnet_tpu/gluon/block.py`` for eager training and serving.
A Gluon block created inside its parent's ``name_scope`` gets the
parent's prefix plus its own (``"enc_"``, ``"layer0_"``, ``"attn_"``,
...), and its parameters are named prefix +
``weight``/``bias``/``gamma``/``beta``.
Each :class:`Block` keeps its own prefix; :meth:`Block.gluon_params`
joins them along the module tree, so the port's parameters carry the
JAX model's names without the model prefix (``bertmodel0_``). That is
what :meth:`Block.load_gluon_params` matches weights by.

Parameters are made at construction with their full shapes on the
block's device (no deferred shapes; ``hybridize`` has no counterpart:
PyTorch runs eagerly). Each takes a gradient per its ``grad_req``
(``"write"`` by default, see ``autograd``); :meth:`Block.collect_params`
gives their Gluon :class:`~.parameter.Parameter` views for a
``Trainer``. A block records a graph only inside ``autograd.record()``:
called anywhere else it runs with torch's gradient mode off, as an
MXNet block records nothing outside ``record()``. Train/predict mode is
``autograd.is_training()``, not ``nn.Module.training``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import autograd
from .parameter import Parameter, ParameterDict

__all__ = ["Block"]


class Block(nn.Module):
    """``nn.Module`` with a Gluon prefix (see module docstring)."""

    def __init__(self, prefix=""):
        super().__init__()
        self._prefix = prefix or ""

    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args, **kwargs)

    def _param(self, shape, dtype, device, fill=0.0, grad_req="write"):
        p = nn.Parameter(torch.full(tuple(shape), fill, dtype=dtype,
                                    device=device))
        return autograd.set_grad_req(p, grad_req)

    def gluon_params(self):
        """``{gluon name (model prefix stripped): parameter}`` in
        registration order."""
        out = {}

        def walk(mod, prefix):
            for name, p in mod.named_parameters(recurse=False):
                out[prefix + name] = p
            for child in mod.children():
                walk(child, prefix + getattr(child, "_prefix", ""))

        walk(self, "")
        return out

    def collect_params(self):
        """:class:`~.parameter.ParameterDict` of the block's parameters
        by Gluon name (model prefix stripped)."""
        return ParameterDict(self._prefix, (
            (name, Parameter.of(name, p))
            for name, p in self.gluon_params().items()))

    def zero_grad(self):
        """Zero every parameter's gradient (MXNet's, not
        ``nn.Module.zero_grad``'s drop to None)."""
        self.collect_params().zero_grad()

    @torch.no_grad()
    def initialize(self, seed=0, sigma=0.02):
        """Seeded weights: every ``weight`` ~ Normal(0, ``sigma``),
        drawn in registration order from numpy's generator (so one
        seed gives the same weights on every device), ``gamma`` ones,
        ``bias``/``beta`` zeros."""
        rng = np.random.default_rng(seed)
        for name, p in self.gluon_params().items():
            if name.endswith("weight"):
                w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
                p.copy_(torch.from_numpy(w * np.float32(sigma)))
            else:
                p.fill_(1.0 if name.endswith("gamma") else 0.0)
        return self

    @torch.no_grad()
    def load_gluon_params(self, params):
        """Copy ``{name: array}`` (Gluon names, model prefix stripped)
        into the parameters. Raises ``KeyError`` on a missing or an
        extra name and ``ValueError`` on a shape that differs."""
        mine = self.gluon_params()
        missing = sorted(set(mine) - set(params))
        extra = sorted(set(params) - set(mine))
        if missing or extra:
            raise KeyError(f"parameter names differ: missing {missing}, "
                           f"extra {extra}")
        for name, p in mine.items():
            arr = np.asarray(params[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"parameter {name}: shape "
                                 f"{tuple(arr.shape)}, the port's is "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
        return self
