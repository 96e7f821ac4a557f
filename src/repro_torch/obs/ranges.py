"""Named ranges on the profiler's clock: the card's counterpart of the virtual-clock tracer.

The training path opens ranges named ``repro.<layer>.<part>`` around the
work of each layer (the driver's batch, the step, each slot, the forward,
the backward, the accumulation, the reduction, the optimizer, and the
model's attention, MoE, dense MLP and head).  They exist only while a
``torch.profiler`` session is active: :func:`region` then opens a
``torch.profiler.record_function`` range, which lands on the same clock as
the device trace, so each kernel and each idle gap of a profiled step can be
put down to the range that launched it or held the card idle.  With no
session active :func:`region` returns :data:`NULL_REGION` after one flag
check, and nothing is inserted anywhere.

A model region also names its backward: ``with region(name) as r`` gives
``r.input(x)`` and ``r.output(y)``, which under an active profiler wrap the
region's input and output in two identity ``autograd.Function``s.  The one
on the output opens ``<name>.bwd`` when its gradient arrives (its backward
runs first); the one on the input closes it once the region's gradient is
through.  The autograd engine runs both on its own thread, outside any
forward range.  Where a backward raises, or a graph never reaches a
region's input, the range still open is closed when the region around the
backward call (``repro.train.backward``) exits.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

__all__ = ["NULL_REGION", "active", "region"]


class _Pending:
    """A region's backward range: its name, and its ``record_function`` while open."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str) -> None:
        self.name, self.rf = name, None


# the backward ranges open now, in the order they opened: process-wide, as the
# profiler session is, so that the region around a backward call can close
# what a backward that raised left open
_OPEN: list[_Pending] = []


def active() -> bool:
    """Whether a profiler session is recording (one module attribute read)."""
    return _profiler._is_profiler_enabled


class _NullRegion:
    """What :func:`region` returns while no profiler is active: enters and
    exits doing nothing; ``input`` and ``output`` hand their tensor back."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def input(x):
        return x

    @staticmethod
    def output(y):
        return y


NULL_REGION = _NullRegion()


def _open_backward(pending: _Pending) -> None:
    if pending.rf is None:
        pending.rf = _profiler.record_function(pending.name)
        pending.rf.__enter__()
        _OPEN.append(pending)


def _close_backward(pending: _Pending) -> None:
    rf, pending.rf = pending.rf, None
    if rf is not None:
        rf.__exit__(None, None, None)
        _OPEN.remove(pending)


class _BwdOpen(torch.autograd.Function):
    """Identity on a region's output; its backward opens the region's ``.bwd`` range."""

    @staticmethod
    def forward(ctx, pending, y):
        ctx.pending = pending
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        _open_backward(ctx.pending)
        return None, grad


class _BwdClose(torch.autograd.Function):
    """Identity on a region's input; its backward closes the region's ``.bwd`` range."""

    @staticmethod
    def forward(ctx, pending, x):
        ctx.pending = pending
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _close_backward(ctx.pending)
        return None, grad


class _Region:
    """A live region: a ``record_function`` range for its body, and its
    backward bracketed through ``input``/``output``."""

    __slots__ = ("name", "_rf", "_depth", "_pending")

    def __init__(self, name: str) -> None:
        self.name = name
        self._pending = None

    def __enter__(self):
        self._depth = len(_OPEN)
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        # backward ranges opened inside this region and never closed (a backward that raised)
        while len(_OPEN) > self._depth:
            _close_backward(_OPEN[-1])
        self._rf.__exit__(*exc)
        return False

    def input(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            self._pending = _Pending(f"{self.name}.bwd")
            return _BwdClose.apply(self._pending, x)
        return x

    def output(self, y):
        if self._pending is not None and y.requires_grad:
            return _BwdOpen.apply(self._pending, y)
        return y


def region(name: str):
    """A range named ``name`` on the profiler's clock while a profiler is
    active, else :data:`NULL_REGION`; use as ``with region(name) as r``."""
    if not active():
        return NULL_REGION
    return _Region(name)
