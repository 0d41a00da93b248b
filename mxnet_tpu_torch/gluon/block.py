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
block's device (no deferred shapes). ``HybridBlock`` is another name
for :class:`Block`: PyTorch runs eagerly, and :meth:`Block.hybridize`
records its arguments and compiles nothing (a CUDA graph of the step
is ROADMAP Queue 1 item 4). :meth:`Block.cast` changes the
parameters' type in place, as the JAX block's does. Each parameter
takes a gradient per its ``grad_req`` (``"write"`` by default, see
``autograd``); :meth:`Block.collect_params`
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

from .. import autograd, initializer
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


# parameter names the default fill sets to one (the rest but weights: 0)
_ONES = ("gamma", "running_var", "moving_var")


class Block(nn.Module):
    """``nn.Module`` with a Gluon prefix (see module docstring)."""

    def __init__(self, prefix=""):
        super().__init__()
        self._prefix = prefix or ""

    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args, **kwargs)

    def _param(self, shape, dtype, device, fill=0.0, grad_req="write",
               init=None):
        p = nn.Parameter(torch.full(tuple(shape), fill, dtype=dtype,
                                    device=device))
        if init is not None:
            p._mx_init = init       # this parameter's own initializer
        return autograd.set_grad_req(p, grad_req)

    def hybridize(self, active=True, **kwargs):
        """Accepted for the API (``static_alloc``, ``static_shape``,
        ...) and recorded on the block and its children; nothing is
        compiled: the port runs eagerly (a CUDA graph of the step is
        ROADMAP Queue 1 item 4)."""
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._hybridize = (bool(active), dict(kwargs))
        return self

    @torch.no_grad()
    def cast(self, dtype):
        """Cast every parameter to ``dtype`` in place (the tensors stay
        the same ``nn.Parameter`` objects; old gradients are dropped).
        A layer may keep some of its own in another type: ``BatchNorm``
        keeps float32 for float16 and bfloat16."""
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dt)
            else:
                child.to(dt)
        for p in self.parameters(recurse=False):
            p.data = p.data.to(dt)
            p.grad = None
        return self

    def gluon_params(self):
        """``{gluon name (model prefix stripped): parameter}`` in
        registration order. Raises ``ValueError`` when two parameters
        come to one name (children that need prefixes were given
        none)."""
        out = {}

        def walk(mod, prefix):
            for name, p in mod.named_parameters(recurse=False):
                if prefix + name in out:
                    raise ValueError(f"two parameters named "
                                     f"{prefix + name!r}: give the "
                                     f"children their Gluon prefixes")
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
    def initialize(self, init=None, seed=0, sigma=0.02):
        """Seeded weights, drawn in registration order from one numpy
        generator (so one seed gives the same weights on every device).
        A parameter made with its own initializer (``_param(...,
        init=)``, e.g. an LSTM's ``"zeros"`` biases) takes that one;
        the others take ``init`` (an ``initializer.Initializer`` or a
        registered name) by their names. Without ``init`` they keep
        the default: every ``weight`` ~ Normal(0, ``sigma``), ``gamma``
        and running variances ones, ``bias``/``beta`` and running means
        zeros (as ``Initializer`` dispatches by name)."""
        rng = np.random.default_rng(seed)
        default = None if init is None else initializer.create(init)
        for name, p in self.gluon_params().items():
            own = getattr(p, "_mx_init", None)
            chosen = default if own is None else initializer.create(own)
            if chosen is not None:
                chosen(name, p, rng)
            elif name.endswith("weight"):
                w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
                p.copy_(torch.from_numpy(w * np.float32(sigma)))
            else:
                p.fill_(1.0 if name.endswith(_ONES) else 0.0)
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


HybridBlock = Block
