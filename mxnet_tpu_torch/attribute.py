"""Scoped attributes (port of ``mxnet_tpu/attribute.py``, MXNet's
``attribute.py``): :class:`AttrScope` holds string attributes that
nested scopes merge and :meth:`AttrScope.get` returns, merged with the
ones it is given. The port has no symbols; the scopes keep their
mechanics for code written against them."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = {str(k): str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attr=None):
        cur = getattr(AttrScope._current, "value", None)
        merged = dict(cur._attr) if cur else {}
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        self._old = getattr(AttrScope._current, "value", None)
        if self._old is not None:
            merged = dict(self._old._attr)
            merged.update(self._attr)
            self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old
        return False

    @staticmethod
    def current():
        cur = getattr(AttrScope._current, "value", None)
        if cur is None:
            cur = AttrScope()
            AttrScope._current.value = cur
        return cur


def current():
    return AttrScope.current()
