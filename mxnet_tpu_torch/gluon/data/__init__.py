"""Data loading (``mxnet_tpu/gluon/data``'s counterpart): datasets,
samplers, the DataLoader and the vision datasets and transforms."""
from __future__ import annotations

from . import vision
from .dataloader import DataLoader
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,
                      SequentialSampler)

__all__ = ["ArrayDataset", "BatchSampler", "DataLoader", "Dataset",
           "RandomSampler", "RecordFileDataset", "Sampler", "SequentialSampler", "SimpleDataset",
           "vision"]
