"""Global random state: ``mx.random.seed`` and ``get_state``.

Port of ``mxnet_tpu/random.py``. MXNet gives every device one
persistent generator, seeded by ``mx.random.seed``; the JAX package
keeps one threefry key chain for the process. Here each device's
generator is torch's own default one (``torch.default_generator`` for
the CPU, ``torch.cuda.default_generators[i]`` for card ``i``), so the
``Dropout`` op and layer (``F.dropout``), the LSTM op's inter-layer
dropout and the ``random_*``/``sample_*`` ops all draw from it.
:func:`seed` with ``ctx="all"`` seeds every device, with a context only
that one. The bits differ from ``jax.random``'s by design; a seed gives
one sequence of draws per device.
"""
from __future__ import annotations

import torch

__all__ = ["generator", "get_state", "seed"]


def _device(ctx):
    from .context import Context, resolve_device
    if isinstance(ctx, torch.device):
        return ctx
    if isinstance(ctx, (Context, str)) or ctx is None:
        return resolve_device(ctx)
    raise TypeError(f"not a device or a context: {ctx!r}")


def generator(device=None):
    """The generator of ``device`` (a ``torch.device``, a context, or
    None for the current context's)."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.init()               # fills default_generators
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def seed(seed_state, ctx="all"):
    """Seed every device's generator, or ``ctx``'s alone."""
    s = int(seed_state)
    if ctx == "all":
        torch.manual_seed(s)            # the CPU and every card
    else:
        generator(ctx).manual_seed(s)


def get_state(ctx=None):
    """The generator state of ``ctx``'s device (a byte tensor that
    ``generator(ctx).set_state`` takes back)."""
    return generator(ctx).get_state()
