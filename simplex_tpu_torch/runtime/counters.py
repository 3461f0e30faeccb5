"""Counters that stay exact when several threads solve at once.

The kernel wrappers count their launches, and the solve loops their host
reads, in module-level integers (``pivot_kernel.LAUNCHES``,
``tableau.STATE_READS``, ``graphs.REPLAYS``, ...) that runs and tests read
and reset by name.  A served app solves on several threads, so
:func:`add` raises a counter under one lock, and also keeps what each
thread added in a tally of that thread's own.  A CUDA-graph capture reads
its own thread's tally (:func:`mine`): another thread's launches during
the capture are neither taken off the counter nor recorded as the graph's.
"""
from __future__ import annotations

import threading

_LOCK = threading.Lock()
_TALLY = threading.local()


def add(namespace: dict, name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of a module (``namespace`` is its
    ``globals()``) and to this thread's tally of it."""
    with _LOCK:
        namespace[name] += n
    tally = _TALLY.__dict__.setdefault("counts", {})
    key = (namespace["__name__"], name)
    tally[key] = tally.get(key, 0) + n


def mine(namespace: dict, name: str) -> int:
    """What this thread has added to the counter ``name`` of a module."""
    return getattr(_TALLY, "counts", {}).get((namespace["__name__"], name), 0)
