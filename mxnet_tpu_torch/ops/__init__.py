"""Kernels of the PyTorch port: each a hand-written CUDA kernel
(``csrc/``), its wrapper, and its plain PyTorch version beside it.

The wrappers live in their modules (``ops.flash_attention``,
``ops.layer_norm``, ``ops.lstm``, ``ops.paged_attention``,
``ops.softmax_xent``, and ``ops.image``: the native image batcher's
resize kernel, which has no Pallas counterpart); the package keeps the
modules' names free, so
``ops.flash_attention`` is the module. Each module counts its kernels'
launches by name; a backward counts apart from its forward
(``flash_attention_bwd``, ``layer_norm_bwd``, ``softmax_xent_bwd``,
``lstm_bwd``), and a second kernel of one call apart from the first
(``lstm_bwd_dw``, the LSTM backward's dW product)."""
from __future__ import annotations

from . import flash_attention as _flash
from . import image as _image
from . import layer_norm as _layer_norm
from . import lstm as _lstm
from . import paged_attention as _paged
from . import softmax_xent as _xent
from .layer_norm import layer_norm_fused, layer_norm_reference
from .lstm import lstm_forward_reference, lstm_layer_fused
from .paged_attention import paged_attention_reference, paged_flash_attention
from .softmax_xent import softmax_xent_fused, softmax_xent_reference

__all__ = ["add_launch_counts", "launch_counts", "layer_norm_fused",
           "layer_norm_reference", "lstm_forward_reference",
           "lstm_layer_fused", "paged_attention_reference",
           "paged_flash_attention", "reset_launch_counts",
           "softmax_xent_fused", "softmax_xent_reference"]

# each wrapper module keeps its own {kernel name: launches}
_COUNTS = (_paged.LAUNCHES, _flash.LAUNCHES, _layer_norm.LAUNCHES,
           _xent.LAUNCHES, _lstm.LAUNCHES, _image.LAUNCHES)


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts():
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


def add_launch_counts(delta):
    """Add ``{kernel name: launches}`` to the counts: a CUDA graph's
    replay launches what its capture launched, which the wrappers'
    host counters do not see (``graphs.Graph.replay``)."""
    for table in _COUNTS:
        for name in table:
            n = delta.get(name)
            if n:
                table[name] += n
