"""Base of the port's layers: an ``nn.Module`` that carries Gluon's
parameter naming.

Port of the naming half of ``mxnet_tpu/gluon/block.py``. A Gluon block
created inside its parent's ``name_scope`` gets the parent's prefix
plus its own (``"enc_"``, ``"layer0_"``, ``"attn_"``, ...), and its
parameters are named prefix + ``weight``/``bias``/``gamma``/``beta``.
Each :class:`Block` keeps its own prefix; :meth:`Block.gluon_params`
joins them along the module tree, so the port's parameters carry the
JAX model's names without the model prefix (``bertmodel0_``). That is
what :meth:`Block.load_gluon_params` matches weights by.

No deferred shapes, no hybridize, no autograd: parameters are made at
construction with their full shapes on the block's device, and do not
require gradients (this part of the port is forward only).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["Block"]


class Block(nn.Module):
    """``nn.Module`` with a Gluon prefix (see module docstring)."""

    def __init__(self, prefix=""):
        super().__init__()
        self._prefix = prefix or ""

    def _param(self, shape, dtype, device, fill=0.0):
        return nn.Parameter(torch.full(tuple(shape), fill, dtype=dtype,
                                       device=device),
                            requires_grad=False)

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
