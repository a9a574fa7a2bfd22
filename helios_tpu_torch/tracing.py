"""The host's spans of a run, and the loop that runs.

A :class:`span` (``helios.<phase>``) times a block of the host's work into
a field of a loop's Stats (``rce.graphs.Stats``) and, while a profiler
records, is a ``record_function`` range on the clock of the device's
kernels.  :func:`running` marks the Stats of the loop whose runner runs
(``rce.graphs.run_loop``), so that work deep inside an iteration
(:func:`mixing`, the convective adjustment's reads) counts into its loop
without the layers below the loops knowing them.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

_RUNNING: contextvars.ContextVar = contextvars.ContextVar(
    "running_loop_stats", default=None)


class span:
    """A block of the run's host time named ``name`` (``helios.<phase>``):
    its seconds (``.seconds`` once it ends) are added to ``stats.<field>``
    when ``stats`` is given.  While a profiler records, the block is also a
    ``torch.profiler.record_function`` range, on the clock of the device's
    kernels in the trace; else only the check is paid (the range costs
    some microseconds, the check a fraction of one).  A span waits for no
    device work: a phase that should end with its device work synchronises
    inside its block."""
    __slots__ = ("name", "stats", "field", "seconds", "_t0", "_range")

    def __init__(self, name: str, stats=None, field: str = None):
        self.name, self.stats, self.field = name, stats, field
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.stats is not None:
            setattr(self.stats, self.field,
                    getattr(self.stats, self.field) + self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


@contextlib.contextmanager
def running(stats):
    """The block in which the loop of ``stats`` runs its iterations."""
    token = _RUNNING.set(stats)
    try:
        yield
    finally:
        _RUNNING.reset(token)


def running_stats():
    """The Stats of the loop whose runner runs, or None outside one."""
    return _RUNNING.get()


@contextlib.contextmanager
def mixing():
    """One on-the-fly opacity mixing pass (``chem.mixed_opacities``): the
    span ``helios.mix``, whose seconds go to the running loop's ``mix_s``,
    and one pass more in its ``mixes``.  Outside a loop only the span."""
    stats = _RUNNING.get()
    with span("helios.mix", stats, "mix_s"):
        yield
    if stats is not None:
        stats.mixes += 1
