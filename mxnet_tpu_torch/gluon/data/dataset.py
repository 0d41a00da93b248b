"""Datasets (``mxnet_tpu/gluon/data/dataset.py``'s counterpart, numpy
only), and ``RecordFileDataset``: the raw records of an indexed
RecordIO file (``recordio.MXIndexedRecordIO``)."""
from __future__ import annotations

__all__ = ["ArrayDataset", "Dataset", "RecordFileDataset", "SimpleDataset"]


class Dataset:
    """Indexable samples: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of [0, {num_shards})")
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _LazySlice(self, start, end)

    def take(self, count):
        return _LazySlice(self, 0, min(count, len(self)))

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A list (or any indexable) as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazySlice(Dataset):
    def __init__(self, dataset, start, end):
        self._dataset = dataset
        self._start, self._end = start, end

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._dataset[self._start + idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of arrays or datasets of one length: sample ``i`` is the
    tuple of their ``i``-th items (the item itself for one array)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; array[0] has "
                    f"length {self._length} while array[{i}] has "
                    f"{len(data)}.")
            if isinstance(data, (list, tuple)) or hasattr(data, "shape"):
                self._data.append(data)
            else:
                self._data.append(list(data))

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of an indexed RecordIO file, in the ``.idx``'s order
    (the ``.idx`` beside the ``.rec``): sample ``i`` is record ``i``'s
    raw bytes."""

    def __init__(self, filename):
        from ... import recordio
        self.idx_file = filename[:-4] + ".idx" if filename.endswith(".rec") \
            else filename + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
