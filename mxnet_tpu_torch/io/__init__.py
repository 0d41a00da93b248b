"""Data input of the PyTorch port (``mxnet_tpu/io``'s counterpart): the
data iterators (``io.py``: ``NDArrayIter``, ``CSVIter``, ``LibSVMIter``,
``MNISTIter``, ``ImageRecordIter``, ...), the native RecordIO reader and
image batcher (``native.py``) and the sequence packing encoder serving
uses (``packing.py``)."""
from __future__ import annotations

from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter,
                 ImageRecordIterNative, LibSVMIter, MNISTIter, NDArrayIter,
                 PrefetchingIter, ResizeIter)
from .packing import (PackedBatch, Placement, pack_sequences,
                      packing_efficiency, unpack_sequences)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "ImageRecordIter",
           "ImageRecordIterNative", "LibSVMIter", "MNISTIter", "NDArrayIter",
           "PackedBatch", "Placement", "PrefetchingIter", "ResizeIter",
           "pack_sequences", "packing_efficiency", "unpack_sequences"]
