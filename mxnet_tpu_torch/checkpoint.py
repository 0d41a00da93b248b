"""Preemption-aware checkpoint and resume.

Port of ``mxnet_tpu/checkpoint.py`` for one process. A
:class:`CheckpointManager`

- saves periodically (``every_n_steps``) through the normal parameter
  and trainer-state files (``PREFIX-STEP.params`` /
  ``PREFIX-STEP.states``) and a ``PREFIX-STEP.meta.json`` sidecar with
  the reference's keys (``step``, ``time``, ``tag``, ``sharded``,
  ``num_processes``);
- installs signal handlers (SIGTERM by default: the preemption notice)
  that snapshot at once and then re-deliver the signal to the previous
  handler (a default SIGTERM still ends the process);
- prunes to the newest ``max_keep`` checkpoints;
- finds the newest checkpoint at start-up (:meth:`latest_step`,
  :meth:`restore`), so a restarted job resumes where it died.

``sharded=True`` (each process writing its shards) raises: it needs
several devices (ROADMAP 'Multi-GPU').
"""
from __future__ import annotations

import glob
import json
import os
import signal as _signal
import time

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Periodic and signal-triggered checkpoints of ``net`` and
    ``trainer`` under ``prefix`` (module docstring)."""

    def __init__(self, prefix, net=None, trainer=None, max_keep=5,
                 every_n_steps=None, signals=(_signal.SIGTERM,),
                 sharded=False):
        if sharded:
            raise ValueError(f"sharded={sharded!r}: sharded checkpoints "
                             f"span several devices (ROADMAP 'Multi-GPU')")
        self._prefix = prefix
        self._net = net
        self._trainer = trainer
        self._max_keep = max_keep
        self._every = every_n_steps
        self._step = 0
        self._preempted = False
        self._prev_handlers = {}
        for sig in signals or ():
            try:
                self._prev_handlers[sig] = _signal.signal(sig,
                                                          self._on_signal)
            except (ValueError, OSError):
                pass        # not on the main thread / unsupported signal

    def _on_signal(self, signum, frame):
        """Preemption notice: snapshot now, then re-deliver with the
        previous disposition (a SIG_DFL SIGTERM still terminates)."""
        self._preempted = True
        try:
            self.save(tag="preempt")
        finally:
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == _signal.SIG_DFL:
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            # SIG_IGN: swallowed, as it was before

    @property
    def preempted(self):
        return self._preempted

    def step(self, increment=1):
        """Advance the step counter; save when the cadence fires."""
        self._step += increment
        if self._every and self._step % self._every == 0:
            self.save()
        return self._step

    def save(self, tag=None):
        """Write this step's files; returns their paths."""
        base = f"{self._prefix}-{self._step:07d}"
        wrote = []
        if self._net is not None:
            self._net.save_parameters(base + ".params")
            wrote.append(base + ".params")
        if self._trainer is not None:
            self._trainer.save_states(base + ".states")
            wrote.append(base + ".states")
        meta = {"step": self._step, "time": time.time(),
                "tag": tag or "periodic", "sharded": False,
                "num_processes": 1}
        with open(base + ".meta.json", "w") as f:
            json.dump(meta, f)
        wrote.append(base + ".meta.json")
        self._prune()
        return wrote

    def _checkpoints(self):
        out = []
        for m in sorted(glob.glob(f"{self._prefix}-*.meta.json")):
            try:
                with open(m) as f:
                    out.append((json.load(f)["step"],
                                m[:-len(".meta.json")]))
            except (ValueError, KeyError):
                continue
        return sorted(out)

    def _prune(self):
        ckpts = self._checkpoints()
        for _, base in ckpts[:-self._max_keep] if self._max_keep else []:
            for f in glob.glob(base + ".*"):
                try:
                    os.remove(f)
                except OSError:
                    pass

    def latest_step(self):
        """Step of the newest checkpoint, or None."""
        ckpts = self._checkpoints()
        return ckpts[-1][0] if ckpts else None

    def restore(self, net=None, trainer=None):
        """Load the newest checkpoint into ``net``/``trainer``; returns
        its step (0 when there is none: a fresh start)."""
        ckpts = self._checkpoints()
        if not ckpts:
            return 0
        step, base = ckpts[-1]
        net = net or self._net
        trainer = trainer or self._trainer
        if net is not None:
            net.load_parameters(base + ".params")
        if trainer is not None and os.path.exists(base + ".states"):
            trainer.load_states(base + ".states")
        self._step = step
        return step

    def close(self):
        """Put the previous signal handlers back."""
        for sig, prev in self._prev_handlers.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
