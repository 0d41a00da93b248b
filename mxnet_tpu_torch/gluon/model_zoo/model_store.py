"""Local pretrained-weight store (port of
``mxnet_tpu/gluon/model_zoo/model_store.py``, MXNet's
``python/mxnet/gluon/model_zoo/model_store.py``).

MXNet resolves a model name to ``{name}-{sha1[:8]}.params`` in a local
root, verifies the SHA-1 and downloads on a miss. This store never
downloads: weights enter it through :func:`publish_model_file`, the
hashes live beside the files in ``model_index.json``, and
:func:`get_model_file` resolves and verifies as MXNet's does. A miss
raises with the publish instructions; a file whose SHA-1 disagrees
with the index raises and is never loaded.

The root is the ``root`` argument, else ``$MXNET_TPU_MODEL_STORE``,
else ``$MXNET_HOME/models``, else ``~/.mxnet/models`` (MXNet's
default). The files are the ``.params`` format both packages read, so
one store serves both.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

from ...base import MXNetError

__all__ = ["get_model_file", "load_pretrained", "publish_model_file",
           "purge", "short_hash"]

_INDEX = "model_index.json"


def _default_root():
    from ... import envvars
    env = envvars.get("MXNET_TPU_MODEL_STORE")
    if env:
        return env
    home = os.environ.get("MXNET_HOME")
    if home:
        return os.path.join(home, "models")
    return os.path.join("~", ".mxnet", "models")


def _root(root):
    return os.path.expanduser(root or _default_root())


def _load_index(root):
    path = os.path.join(root, _INDEX)
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_index(root, index):
    with open(os.path.join(root, _INDEX), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)


def _sha1(path):
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def short_hash(name, root=None):
    """The first 8 characters of the stored file's SHA-1 (the stamp in
    its file name)."""
    root = _root(root)
    index = _load_index(root)
    if name not in index:
        raise ValueError(f"{name} is not present in the model store "
                         f"at {root}")
    return index[name]["sha1"][:8]


def get_model_file(name, root=None):
    """The path of the verified ``{name}-{sha1[:8]}.params``.

    An indexed name whose file is gone or whose SHA-1 disagrees
    raises; it never falls back to an unverified file. An unindexed
    ``{name}.params`` placed in the root by hand is returned as it is
    (nothing records its hash). Otherwise raises with the publish
    instructions."""
    root = _root(root)
    index = _load_index(root)
    if name in index:
        entry = index[name]
        fname = os.path.join(root, entry["file"])
        if not os.path.isfile(fname):
            raise MXNetError(
                f"the model store index at {root} names {entry['file']} "
                f"for {name!r} but the file is gone; re-publish it with "
                f"publish_model_file")
        if _sha1(fname) != entry["sha1"]:
            raise MXNetError(
                f"checksum mismatch for {fname} (expected "
                f"{entry['sha1']}); the stored weights are corrupt: "
                f"re-publish them with publish_model_file")
        return fname
    bare = os.path.join(root, f"{name}.params")
    if os.path.isfile(bare):
        return bare
    raise MXNetError(
        f"pretrained weights for {name!r} are not in the local model "
        f"store at {root}, and the store does not download. Publish "
        f"them once with\n"
        f"  mxnet_tpu_torch.gluon.model_zoo.model_store.publish_model_file("
        f"{name!r}, '/path/to/{name}.params')\n"
        f"or put a {name}.params file into {root}.")


def publish_model_file(name, path, root=None):
    """Copy ``path`` into the store as ``{name}-{sha1[:8]}.params`` and
    record its hash in the index; a file published before under
    ``name`` is removed. Returns the stored path."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    if not os.path.isfile(path):
        raise MXNetError(f"no weights file at {path}")
    sha = _sha1(path)
    fname = f"{name}-{sha[:8]}.params"
    dst = os.path.join(root, fname)
    if os.path.abspath(path) != os.path.abspath(dst):
        shutil.copyfile(path, dst)
    index = _load_index(root)
    prev = index.get(name)
    index[name] = {"file": fname, "sha1": sha}
    _save_index(root, index)
    if prev and prev["file"] != fname:
        old = os.path.join(root, prev["file"])
        if os.path.isfile(old):
            os.remove(old)
    return dst


def load_pretrained(net, name, ctx=None, root=None):
    """Load the verified weights of ``name`` into ``net`` (the tail of
    every model-zoo ``pretrained=True``); returns ``net``."""
    net.load_parameters(get_model_file(name, root=root), ctx=ctx)
    return net


def purge(root=None):
    """Remove every stored ``.params`` file and the index."""
    root = _root(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params") or f == _INDEX:
            os.remove(os.path.join(root, f))
