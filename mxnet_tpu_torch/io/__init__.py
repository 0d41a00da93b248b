"""Data input helpers of the PyTorch port (``mxnet_tpu/io``'s
counterpart, reduced to the sequence packing encoder serving uses)."""
from __future__ import annotations

from .packing import (PackedBatch, Placement, pack_sequences,
                      packing_efficiency, unpack_sequences)

__all__ = ["PackedBatch", "Placement", "pack_sequences",
           "packing_efficiency", "unpack_sequences"]
