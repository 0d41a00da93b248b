"""Automatic naming (port of ``mxnet_tpu/name.py``, MXNet's
``name.py``): :class:`NameManager` gives ``<hint><count>`` names, per
manager; :class:`Prefix` puts a prefix before them. ``with`` makes one
current for its thread."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old
        return False

    @staticmethod
    def current():
        cur = getattr(NameManager._current, "value", None)
        if cur is None:
            cur = NameManager()
            NameManager._current.value = cur
        return cur


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(name, hint)
