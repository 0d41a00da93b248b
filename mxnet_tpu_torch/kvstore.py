"""KVStore: the single-process key-value store.

Port of the single-process part of ``mxnet_tpu/kvstore.py``
(``create``, ``KVStore``, ``_merge_row_sparse``). ``create`` takes
``local``, ``device``, ``nccl`` and their aliases; each is one store
on the calling process's card. The store keeps a copy of each
initialized value; ``push`` sums the values given for a key (a list of
arrays, several replicas' gradients) and either writes the sum into
the stored value or, after :meth:`KVStore.set_optimizer`, runs the
updater on it (``update_on_kvstore``); ``pull`` copies the stored
value out. Keys are integers or strings (the reference's sparse
example keys its weight ``"weight"``).

**row_sparse.** A pushed ``RowSparseNDArray`` merges by unique row id
(``torch.unique``, then ``op_impl_basic.segment_sum``: a fixed order,
the same bits on every run) and reaches the updater still row_sparse,
so the optimizer takes its lazy row update; without an updater the
merged rows, densified, replace the stored value. The JAX store
merges only when several arrays are pushed and hands a single one to
the updater as it is; here a single array merges too, so repeated row
ids in one push add up (the reference's unique-row-id merge), where
the JAX package's row update would keep one of them. Ids given unique,
the two agree. :meth:`KVStore.row_sparse_pull` gathers the unique
requested rows of the stored value on its device (the count of unique
ids is read on the host to size the result) into a dense destination
(the other rows zero) or a row_sparse one (its values and ids
replaced in place).

One store holds one replica, so ``set_gradient_compression`` checks
its type as the JAX store does and compresses nothing, as the JAX
reduce compresses nothing with one device. The distributed stores
(``dist_sync``, ``dist_async``, ``dist_device_sync``, ``horovod``)
raise ``NotImplementedError`` (ROADMAP Queue 1, 'Multi-GPU'), and
``expose`` (the telemetry server) raises too ('Serving remainders').
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import sparse as _sp
from .ndarray.ndarray import NDArray, as_nd
from .ndarray.op_impl_basic import segment_sum
from .optimizer.optimizer import get_updater, move_state

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu", "device",
          "local_allreduce_device", "nccl")
_DIST = ("dist_async", "dist_sync", "dist_device_sync", "dist_sync_device",
         "dist", "horovod")


def create(name="local"):
    """A store by type name (``mx.kv.create``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in _LOCAL:
        return KVStore(name)
    if name in _DIST:
        raise NotImplementedError(
            f"kvstore {name!r}: the distributed key-value stores are not "
            f"ported yet (ROADMAP Queue 1, 'Multi-GPU'); use 'local' or "
            f"'device' on one card")
    raise MXNetError(f"unknown kvstore type {name!r}")


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def _listed(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _copy(v):
    if isinstance(v, _sp.BaseSparseNDArray):
        return v.copy()
    t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return as_nd(t.clone(), v)


class KVStore:
    """The single-process store (module docstring)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}
        self._updater = None

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of ``value`` (of its first array, for a list)
        under each key; a key initialized twice raises."""
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            self._store[k] = _copy(_listed(v)[0])

    def push(self, key, value, priority=0):
        """Sum the values of each key, then update the stored value
        (through the updater, when one is set)."""
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            self._apply(k, self._reduce(_listed(v)))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its ``out`` arrays."""
        keys, outs = _normalize(key, out)
        for k, o in zip(keys, outs):
            stored = self._get(k)
            for dst in _listed(o):
                stored.copyto(dst)

    def pushpull(self, key, value, out=None, priority=0):
        """``push`` then ``pull`` (into ``value`` when ``out`` is
        None)."""
        self.push(key, value, priority)
        self.pull(key, value if out is None else out, priority)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of each key's stored value into its
        ``out`` arrays (dense or row_sparse; module docstring)."""
        keys, outs = _normalize(key, out)
        _, rids = _normalize(key, row_ids)
        for k, o, r in zip(keys, outs, rids):
            stored = self._get(k)
            dense = stored.todense() \
                if isinstance(stored, _sp.BaseSparseNDArray) else stored
            dsts = _listed(o)
            rows = r if isinstance(r, (list, tuple)) else [r] * len(dsts)
            for dst, rid in zip(dsts, rows):
                pull_rows(dense, dst, rid)

    def set_optimizer(self, optimizer):
        self._updater = get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """Check the compression type ('2bit', 'int8' or 'none') as the
        JAX store does; one replica has nothing to compress."""
        ctype = dict(compression_params).get("type", "2bit")
        if ctype not in ("2bit", "int8", "none"):
            raise MXNetError(f"unsupported gradient compression type "
                             f"{ctype!r}")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer set to this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer set to this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        for k, state in self._updater.states.items():
            self._updater.states[k] = move_state(state, self._get(k).device)

    def expose(self, port=0, host="127.0.0.1"):
        raise NotImplementedError(
            "KVStore.expose: the telemetry server is not ported yet "
            "(ROADMAP Queue 1, 'Serving remainders')")

    def _get(self, k):
        if k not in self._store:
            raise MXNetError(f"key {k} was not initialized")
        return self._store[k]

    @staticmethod
    def _reduce(arrays):
        """The sum of one key's pushed arrays, in the order given."""
        if any(isinstance(a, _sp.RowSparseNDArray) for a in arrays):
            return _merge_row_sparse(arrays)
        acc = arrays[0]
        for a in arrays[1:]:
            acc = acc + a.to(acc.device)
        return acc

    def _apply(self, k, merged):
        stored = self._get(k)
        if isinstance(merged, _sp.BaseSparseNDArray):
            # the updater's optimizer takes the lazy row update
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                merged.todense().astype(stored.dtype).copyto(stored)
            return
        merged = merged.to(device=stored.device, dtype=stored.dtype)
        if self._updater is not None:
            self._updater(k, merged, stored)
        else:
            with torch.no_grad():
                stored.copy_(merged)

    def __repr__(self):
        return f"<KVStore {self._kind} rank={self.rank}/{self.num_workers}>"


def pull_rows(dense, dst, row_ids):
    """The unique rows ``row_ids`` of ``dense`` into ``dst``: a
    RowSparseNDArray (values and ids replaced) or a dense array (those
    rows, the others zero)."""
    src = dense.as_subclass(torch.Tensor) if isinstance(dense, NDArray) \
        else dense
    ids = row_ids.as_subclass(torch.Tensor) \
        if isinstance(row_ids, NDArray) else torch.as_tensor(row_ids)
    uniq = torch.unique(ids.reshape(-1).to(device=src.device,
                                           dtype=torch.int64))
    with torch.no_grad():
        picked = src.index_select(0, uniq)
        if isinstance(dst, _sp.RowSparseNDArray):
            dst._data = as_nd(picked.to(device=dst.device,
                                        dtype=dst.dtype), cls=NDArray)
            dst._aux = uniq.to(dst.device)
            return dst
        full = torch.zeros(src.shape, dtype=dst.dtype, device=src.device)
        full.index_copy_(0, uniq, picked.to(dst.dtype))
        dst.copy_(full)
    return dst


def _merge_row_sparse(arrays):
    """The row_sparse sum of ``arrays`` by unique row id (the
    reference's unique-row-id merge): their rows concatenated, then
    summed into the sorted union of their ids."""
    dev = arrays[0].device
    idx = torch.cat([a._aux.to(dev) for a in arrays])
    dat = torch.cat([a._data.as_subclass(torch.Tensor).detach().to(dev)
                     for a in arrays])
    uniq, inv = torch.unique(idx, return_inverse=True)
    summed = segment_sum(dat, inv, uniq.shape[0])
    return _sp.RowSparseNDArray(summed, uniq, arrays[0].shape)
