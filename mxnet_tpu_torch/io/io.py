"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``LibSVMIter`` and ``MNISTIter``.

Port of ``mxnet_tpu/io/io.py`` (numpy batching on the host; each batch
goes to its ``ctx`` in one copy an array, by default the current
context's device). ``LibSVMIter`` parses a LibSVM text file (ZERO-based
feature ids, the reference's ``iter_libsvm.cc`` contract) into CSR
batches (``ndarray.sparse.CSRNDArray``) with ``round_batch``,
``num_parts``/``part_index`` sharding, a ``label_libsvm`` file and
``max_row_nnz`` (the densest row, for ``sparse.csr_to_ell``).
``ImageRecordIter`` reads RecordIO images through the native batcher,
``ImageRecordIterNative`` (``io.native``: C++ record threads, nvJPEG
and one resize kernel on the card), when the request is a plain resize
from an indexed file, as the JAX package picks its own, and through the
Python pipeline, ``image.ImageRecordIterPy``, otherwise.
"""
from __future__ import annotations

import collections
import threading
from collections import namedtuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray, array

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "ImageRecordIter",
           "ImageRecordIterNative", "LibSVMIter", "MNISTIter", "NDArrayIter",
           "PrefetchingIter", "ResizeIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape(+dtype/layout) descriptor (python/mxnet/io DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError(f"Data must be list of NDArrays, got {type(data)}")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError(f"Label must be list of NDArrays, got "
                            f"{type(label)}")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return (f"{type(self).__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (python/mxnet/io DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize input to list of (name, numpy) — reference io.py
    _init_data."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, torch.Tensor)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [(f"_{i}_{default_name}", d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict")
    out = collections.OrderedDict()
    for k, v in data.items():
        out[k] = v.asnumpy() if isinstance(v, NDArray) else (
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))
    return list(out.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with optional shuffle and padding
    (python/mxnet/io NDArrayIter, incl. pad/discard/roll_over)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.ctx = ctx or current_context()
        self.num_data = self.idx.shape[0]
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        start = max(self.cursor, 0)
        end = min(self.cursor + self.batch_size, self.num_data)
        sel = self.idx[start:end]
        out = []
        for _, arr in data_source:
            part = arr[sel]
            if part.shape[0] < self.batch_size and \
                    self.last_batch_handle == "pad":
                pad_n = self.batch_size - part.shape[0]
                wrap = arr[self.idx[:pad_n]]
                part = np.concatenate([part, wrap], axis=0)
            out.append(array(part, ctx=self.ctx))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        start = max(self.cursor, 0)
        end = min(self.cursor + self.batch_size, self.num_data)
        return self.idx[start:end]


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch (src/io/prefetcher.h analog): overlaps
    host-side batch assembly + H2D with device compute."""

    def __init__(self, iters, rename_data=None, rename_label=None, depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue: collections.deque = collections.deque()
        self._depth = depth
        self._lock = threading.Lock()
        self._stop = False
        self._exhausted = False
        self._cv = threading.Condition(self._lock)
        self._thread = threading.Thread(target=self._worker,
                                        name="mxnet_tpu_torch_io_prefetch",
                                        daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _worker(self):
        while True:
            with self._cv:
                while len(self._queue) >= self._depth and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
            try:
                batches = [i.next() for i in self.iters]
                item = DataBatch(
                    data=sum([b.data for b in batches], []),
                    label=sum([(b.label or []) for b in batches], []),
                    pad=batches[0].pad, index=batches[0].index)
            except StopIteration:
                item = None
            with self._cv:
                self._queue.append(item)
                self._cv.notify_all()
                if item is None:
                    while not self._stop and len(self._queue) > 0 \
                            and self._queue[-1] is None:
                        self._cv.wait()
                    if self._stop:
                        return

    def reset(self):
        with self._cv:
            self._queue.clear()
        for i in self.iters:
            i.reset()
        with self._cv:
            self._cv.notify_all()

    def next(self):
        with self._cv:
            while not self._queue:
                self._cv.wait()
            item = self._queue.popleft()
            self._cv.notify_all()
        if item is None:
            raise StopIteration
        return item

    def iter_next(self):
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False

    def __del__(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class CSVIter(DataIter):
    """CSV file iterator (src/io/iter_csv.cc analog)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="roll_over"
                                  if round_batch else "pad",
                                  ctx=ctx)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


def _parse_libsvm(path, num_features):
    """Parse LibSVM text into CSR triple + labels.

    Format per line: ``<label...> <idx>:<val> <idx>:<val> ...`` with
    zero-based feature indices (the reference LibSVMIter contract,
    src/io/iter_libsvm.cc — NOT the 1-based convention of libsvm
    itself). Multiple leading bare numbers form a multi-value label.
    Returns (data, indices, indptr, labels) numpy arrays; labels has
    shape (n,) when every line has one label else (n, label_width).
    """
    data, indices, indptr, labels = [], [], [0], []
    label_width = None
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            lab = []
            k = 0
            for t in toks:
                if ":" in t:
                    break
                lab.append(float(t))
                k += 1
            if label_width is None:
                label_width = len(lab)
            elif label_width != len(lab):
                raise MXNetError(
                    f"{path}:{ln + 1}: inconsistent label width "
                    f"({len(lab)} vs {label_width})")
            labels.append(lab)
            for t in toks[k:]:
                i, _, v = t.partition(":")
                i = int(i)
                if not 0 <= i < num_features:
                    raise MXNetError(
                        f"{path}:{ln + 1}: feature index {i} outside "
                        f"data_shape ({num_features}); indices are "
                        "ZERO-based (reference LibSVMIter contract)")
                indices.append(i)
                data.append(float(v))
            indptr.append(len(indices))
    labels = np.asarray(labels, np.float32)
    if label_width == 1:
        labels = labels[:, 0]
    return (np.asarray(data, np.float32), np.asarray(indices, np.int64),
            np.asarray(indptr, np.int64), labels)


class LibSVMIter(DataIter):
    """LibSVM text → CSR batch iterator (src/io/iter_libsvm.cc analog;
    the input path of the reference's sparse linear-classification
    examples, example/sparse/linear_classification).

    Yields ``DataBatch`` whose data is a :class:`CSRNDArray`; the label
    comes inline from the data file, or from ``label_libsvm`` (also
    LibSVM-format, for multi-dimensional labels). Whole-file parse at
    construction (the reference streams chunks; these files are
    host-RAM-sized here), per-batch CSR slicing after.

    ``max_row_nnz`` (the densest row of the file) lets callers convert
    batches to fixed-width padded gather form with
    ``ndarray.sparse.csr_to_ell`` (``example/sparse_linear.py`` does);
    nnz varies per batch in raw CSR form.
    """

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 num_parts=1, part_index=0, ctx=None, **kwargs):
        super().__init__(batch_size)
        if isinstance(data_shape, int):
            data_shape = (data_shape,)
        if len(data_shape) != 1:
            raise MXNetError("LibSVMIter: data_shape must be "
                             "(num_features,)")
        self._nfeat = int(data_shape[0])
        self.ctx = ctx or current_context()
        d, i, p, lab = _parse_libsvm(data_libsvm, self._nfeat)
        if label_libsvm is not None:
            if isinstance(label_shape, int):
                label_shape = (label_shape,)
            lw = int(label_shape[0]) if label_shape else 1
            ld, li, lp, _ = _parse_libsvm(label_libsvm, lw)
            n = len(lp) - 1
            dense = np.zeros((n, lw), np.float32)
            rows = np.repeat(np.arange(n), np.diff(lp))
            dense[rows, li] = ld
            lab = dense[:, 0] if lw == 1 else dense
        n = len(p) - 1
        if lab.shape[0] != n:
            raise MXNetError(
                f"LibSVMIter: {n} data rows vs {lab.shape[0]} labels")
        # worker sharding (num_parts/part_index — reference dmlc
        # InputSplit role): contiguous row ranges
        lo = n * part_index // num_parts
        hi = n * (part_index + 1) // num_parts
        self._indptr = p[lo:hi + 1] - p[lo]
        self._indices = i[p[lo]:p[hi]]
        self._values = d[p[lo]:p[hi]]
        self._labels = lab[lo:hi]
        self.num_data = hi - lo
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than the (sharded) data")
        self.round_batch = round_batch
        self.max_row_nnz = int(np.diff(self._indptr).max()) \
            if self.num_data else 0
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._nfeat))]

    @property
    def provide_label(self):
        shp = (self.batch_size,) + self._labels.shape[1:]
        return [DataDesc("softmax_label", shp)]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _rows(self):
        """Row ids of the current batch (wraps when round_batch)."""
        sel = np.arange(self.cursor,
                        min(self.cursor + self.batch_size, self.num_data))
        short = self.batch_size - sel.shape[0]
        if short > 0 and self.round_batch:
            sel = np.concatenate([sel, np.arange(short)])
        return sel

    def getdata(self):
        from ..ndarray.sparse import csr_matrix
        sel = self._rows()
        lens = np.diff(self._indptr)[sel]
        starts = self._indptr[sel]
        pos = np.concatenate([np.arange(s, s + l)
                              for s, l in zip(starts, lens)]) \
            if sel.shape[0] else np.empty(0, np.int64)
        indptr = np.concatenate([[0], np.cumsum(lens)])
        return [csr_matrix((self._values[pos], self._indices[pos], indptr),
                           shape=(sel.shape[0], self._nfeat), ctx=self.ctx)]

    def getlabel(self):
        return [array(self._labels[self._rows()], ctx=self.ctx)]

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.round_batch and end > self.num_data:
            return end - self.num_data
        return 0

    def getindex(self):
        return self._rows()


class MNISTIter(DataIter):
    """MNIST idx-format iterator (src/io/iter_mnist.cc analog)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, num_parts=1, part_index=0, ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                _, _, dims = struct.unpack(">HBB", f.read(4))
                shape = tuple(struct.unpack(">I", f.read(4))[0]
                              for _ in range(dims))
                return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)

        img = read_idx(image).astype(np.float32) / 255.0
        lbl = read_idx(label).astype(np.float32)
        if num_parts > 1:
            img = img[part_index::num_parts]
            lbl = lbl[part_index::num_parts]
        if not flat:
            img = img.reshape(-1, 1, 28, 28)
        else:
            img = img.reshape(-1, 784)
        self._inner = NDArrayIter(img, lbl, batch_size, shuffle=shuffle,
                                  ctx=ctx)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


def ImageRecordIter(**kwargs):
    """RecordIO image batches (``iter_image_recordio_2.cc`` analog), with
    the reference iterator's keywords (``path_imgrec``, ``path_imgidx``,
    ``data_shape``, ``batch_size``, ``shuffle``, ``rand_crop``,
    ``rand_mirror``, ``mean_r``..., ``ctx``). A plain resize to
    ``data_shape`` from an indexed file (no augmenter, one label) goes
    to the native batcher, :class:`ImageRecordIterNative`, as the JAX
    package picks its own; everything else to the Python pipeline,
    ``image.ImageRecordIterPy``. The native batcher's failures raise:
    nothing falls back."""
    aug_keys = {"rand_crop", "rand_mirror", "mean_r", "mean_g", "mean_b",
                "std_r", "std_g", "std_b", "rand_gray", "brightness",
                "contrast", "saturation", "aug_list", "resize", "mean",
                "std"}
    wants_aug = any(kwargs.get(k) for k in aug_keys) \
        or int(kwargs.get("label_width", 1) or 1) > 1
    if not wants_aug and kwargs.get("path_imgidx"):
        return ImageRecordIterNative(**kwargs)
    from ..image import ImageRecordIterPy
    return ImageRecordIterPy(**kwargs)


class ImageRecordIterNative(DataIter):
    """DataIter over the native image batcher (``io.native``): records
    read on C++ threads, JPEG decode and one resize-and-assemble kernel
    a batch on ``ctx``'s device (nvJPEG on the card, PIL and the
    kernel's plain version on the CPU). The batches hold the raw 0-255
    pixel values in ``dtype``, as the JAX iterator's; the last partial
    batch is discarded."""

    def __init__(self, path_imgrec=None, path_imgidx=None,
                 data_shape=(3, 224, 224), batch_size=32, shuffle=False,
                 seed=0, preprocess_threads=4, num_parts=1, part_index=0,
                 label_width=1, data_name="data",
                 label_name="softmax_label", ctx=None, dtype="float32",
                 **kwargs):
        from . import native
        super().__init__(batch_size)
        self._ctx = ctx or current_context()
        self._dtype = dtype
        self._shape = tuple(data_shape)
        self._batcher = native.NativeImageBatcher(
            path_imgrec, path_imgidx, batch_size=batch_size,
            data_shape=self._shape, num_threads=preprocess_threads,
            shuffle=shuffle, seed=seed, num_parts=num_parts,
            part_index=part_index, device=self._ctx)
        self._data_name = data_name
        self._label_name = label_name

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._batcher.reset()

    def next(self):
        out = self._batcher.next()
        if out is None:
            raise StopIteration
        data, labels = out
        x = array(data, ctx=self._ctx, dtype=self._dtype)
        return DataBatch(data=[x], label=[array(labels, ctx=self._ctx)],
                         pad=0)
