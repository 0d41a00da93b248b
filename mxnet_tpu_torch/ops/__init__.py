"""Kernels of the PyTorch port: each a hand-written CUDA kernel
(``csrc/``), its wrapper, and its plain PyTorch version beside it.

The wrappers live in their modules (``ops.flash_attention``,
``ops.layer_norm``, ``ops.paged_attention``, ``ops.softmax_xent``); the
package keeps the modules' names free, so ``ops.flash_attention`` is
the module. Each module counts its kernels' launches by name; a
backward counts apart from its forward (``flash_attention_bwd``,
``layer_norm_bwd``, ``softmax_xent_bwd``)."""
from __future__ import annotations

from . import flash_attention as _flash
from . import layer_norm as _layer_norm
from . import paged_attention as _paged
from . import softmax_xent as _xent
from .layer_norm import layer_norm_fused, layer_norm_reference
from .paged_attention import paged_attention_reference, paged_flash_attention
from .softmax_xent import softmax_xent_fused, softmax_xent_reference

__all__ = ["launch_counts", "layer_norm_fused", "layer_norm_reference",
           "paged_attention_reference", "paged_flash_attention",
           "reset_launch_counts", "softmax_xent_fused",
           "softmax_xent_reference"]

# each wrapper module keeps its own {kernel name: launches}
_COUNTS = (_paged.LAUNCHES, _flash.LAUNCHES, _layer_norm.LAUNCHES,
           _xent.LAUNCHES)


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts():
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0
