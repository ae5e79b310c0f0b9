"""The port's spans: named regions on the profiler's own clock.

Counterpart of ``beer_tpu/utils/profiling.py``'s :func:`named_scope`.
While a ``torch.profiler`` records, a span is a
``torch.profiler.record_function`` event, in the same trace and on the
same clock as the device operations; while none records, it reads one
flag and does nothing else.  A span never synchronises the card and
reads no clock of its own.

Every span of the program is named ``beer.<layer>`` (``beer.vb_step``,
``beer.estep``, ``beer.kernel.<KERNELS key>``, ...), so that the program's
names never equal a caller's.  To see them, run the program inside
``torch.profiler.profile(activities=[CPU, CUDA])`` and read its
``key_averages()`` or its Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import inspect

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def named_scope(name: str):
    """A span named ``name`` (a context manager): a
    ``torch.profiler.record_function`` while a profiler records on this
    thread, a shared no-op context otherwise."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def scoped(name):
    """Decorator: every call of the function inside :func:`named_scope`.

    ``name`` is the span's name, or a function of the call's arguments
    (by parameter name, defaults applied) that returns it; it is called
    only while a profiler records."""

    def wrap(fn):
        sig = inspect.signature(fn) if callable(name) else None

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            label = name
            if sig is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                label = name(**bound.arguments)
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return call

    return wrap
