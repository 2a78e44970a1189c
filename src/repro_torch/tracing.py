"""Spans of the port's own work, recorded where it happens.

``span(name)`` wraps a step of the program. Off (the default) it returns
one shared no-op context: a read of the module flag and nothing else.
On (``enable()``), each span appends ``(name, parent, thread, t0, t1)``
to an in-memory list, with ``t0``/``t1`` on ``time.perf_counter`` and
``parent`` the index of the enclosing span on the same thread (-1 for
none), and opens a profiler range of the same name, so that under
``torch.profiler`` the span sits on the device trace's own clock. The
range is ``torch._C._profiler._RecordFunctionFast``: the range
``torch.profiler.record_function`` opens, without the dispatcher call
that costs a span most of its time; the profiler lists it as a host op
of the span's name. That class is private to torch, so ``enable()``
looks it up, and falls back to ``record_function`` where it is missing.
At most ``LIMIT`` spans are kept; later ones are counted as ``dropped``.

``record()`` returns the spans, ``dropped`` and the kernels' launch
counters (``kernels.build.counters``); ``reset()`` clears the spans.

    from repro_torch import tracing
    tracing.enable()
    ...                      # the program's calls
    rec = tracing.record()   # {"spans": [...], "dropped": 0,
                             #  "counters": {...}}

``docs/TRACING.md`` lists the spans and what each covers.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

LIMIT = 1_000_000

_on = False
_spans: list = []       # [name, parent, thread, t0, t1] per span
_dropped = 0
_generation = 0         # bumped by reset(): older open spans parent nothing
_lock = threading.Lock()
_local = threading.local()


_NOOP = contextlib.nullcontext()
_Range = None           # the profiler range's class, set by enable()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = -1
        if stack and stack[-1][1] == _generation:
            parent = stack[-1][0]
        self.rf = _Range(self.name)
        self.rf.__enter__()
        rec = [self.name, parent, threading.get_ident(),
               time.perf_counter(), None]
        with _lock:
            if len(_spans) < LIMIT:
                idx = len(_spans)
                _spans.append(rec)
            else:
                idx = -1
                _dropped += 1
            gen = _generation
        self.rec = rec
        stack.append((idx, gen))
        return self

    def __exit__(self, *exc):
        self.rec[4] = time.perf_counter()
        _local.stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context for one step of the program named ``name``."""
    return _Span(name) if _on else _NOOP


def enable() -> None:
    global _on, _Range
    _Range = getattr(getattr(torch._C, "_profiler", None),
                     "_RecordFunctionFast", torch.profiler.record_function)
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def record() -> dict:
    """The spans recorded since the last ``reset()`` (a span still open
    has ``t1`` None), the spans dropped past ``LIMIT``, and a copy of the
    kernels' launch counters."""
    from .kernels.build import counters
    with _lock:
        spans = [tuple(r) for r in _spans]
        dropped = _dropped
    return {"spans": spans, "dropped": dropped,
            "counters": counters.as_dict()}


def reset() -> None:
    """Clear the spans and the dropped count (the counters have their own
    ``kernels.build.reset_counters``)."""
    global _spans, _dropped, _generation
    with _lock:
        _spans = []
        _dropped = 0
        _generation += 1
