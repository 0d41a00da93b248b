"""Monitor: statistics of a bound graph's outputs at an interval of
batches (port of ``mxnet_tpu/monitor.py``, MXNet's
``python/mxnet/monitor.py``).

:meth:`Monitor.install` sets the executor's monitor callback, which
``Executor.forward`` calls with each output's name and array, as the
JAX executor does: the outputs an executor returns (copies, never a
graph's static buffers). ``stat_func`` (default: the norm over the
square root of the size) runs when the output is seen; :meth:`toc`
reads the statistics back to the host."""
from __future__ import annotations

import logging
import re

import torch

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / (x.numel() ** 0.5)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(str(name)):
            return
        with torch.no_grad():
            self.queue.append((self.step, str(name), self.stat_func(arr)))

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = []
        queue = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else self.queue
        for n, k, v_list in queue:
            if isinstance(v_list, torch.Tensor):
                v_list = [v_list]
            s = ""
            for v in v_list:
                v = v.detach().as_subclass(torch.Tensor).cpu()
                if v.numel() == 1:
                    s += str(v.reshape(()).item()) + "\t"
                else:
                    s += str(v.numpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
