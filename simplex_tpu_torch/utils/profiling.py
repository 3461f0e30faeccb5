"""Tracing, metrics, and benchmark helpers (port of
``simplex_tpu/utils/profiling.py``).

* :class:`SolveRecord` — structured per-solve record (problem shape,
  engine, pivots, status, wall time) with a JSONL sink;
* :func:`trace_span` — the program's one span helper: a ``torch.profiler``
  annotation (``record_function``, on the device trace's clock), host
  seconds added to per-name totals (:func:`span_stats`), and the span
  itself kept in the calling thread's open solve record;
* :func:`solve_record` / :func:`recorded` — the root of one solve: a
  per-thread record of its spans (``(name, parent, start, end)`` on
  ``time.perf_counter``) and its counts (:func:`count`), kept after it
  closes in a bounded ring that :func:`recent` reads, oldest first.

Spans sit at stage boundaries only: never inside a chunk body that a CUDA
graph captures, nor in per-step or per-pivot code.  A record belongs to
the thread that opened it: work handed to another thread (the certificates
of ``models/batched.py::solve_arrays_stream``) opens a record of its own
there.

:class:`SolveRecord`, :class:`MetricsLog`, :data:`DEFAULT_METRICS` (the
same ``SIMPLEX_TPU_METRICS_FILE`` variable) and :func:`span_stats` are as in
the JAX module.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class SolveRecord:
    engine: str
    n_vars: int
    n_cons: int
    status: int
    iterations: int
    wall_s: float
    batch: int = 1
    extra: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["extra"] is None:
            del d["extra"]
        return json.dumps(d)


class MetricsLog:
    """Append-only JSONL sink for solve records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[SolveRecord] = []

    def log(self, record: SolveRecord):
        self.records.append(record)
        if self.path:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(record.to_json() + "\n")

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            return {"solves": 0}
        total = len(self.records)
        ok = sum(1 for r in self.records if r.status == 0)
        wall = sum(r.wall_s for r in self.records)
        pivots = sum(r.iterations for r in self.records)
        return {
            "solves": total,
            "optimal": ok,
            "total_wall_s": round(wall, 4),
            "total_pivots": pivots,
            "pivots_per_sec": round(pivots / wall, 2) if wall else None,
        }


# Process-wide default sink: every orchestrated solve records here; set
# SIMPLEX_TPU_METRICS_FILE to also append JSONL to disk.
DEFAULT_METRICS = MetricsLog(os.environ.get("SIMPLEX_TPU_METRICS_FILE"))


# Per span name, [count, total host seconds] over the process (bounded by
# the number of names); the web app solves on several threads, so they are
# raised under one lock, as runtime/counters.py raises its counters.
_SPANS: Dict[str, List[float]] = {}
_LOCK = threading.Lock()
# The calling thread's open solve record and the names of its open spans.
_LOCAL = threading.local()
_IDS = itertools.count(1)
# The most closed solve records kept (the oldest go first).
RECORDS_KEPT = 1024
_RECENT: "collections.deque[dict]" = collections.deque(maxlen=RECORDS_KEPT)


@contextlib.contextmanager
def trace_span(name: str):
    """One stage of the program: a ``torch.profiler`` annotation, its host
    seconds added to ``name``'s totals, and, where this thread has a solve
    record open, ``(name, parent, start, end)`` appended to it (``parent``
    the innermost span open around it, None for the root)."""
    rec = getattr(_LOCAL, "record", None)
    if rec is not None:
        stack = _LOCAL.stack
        parent = stack[-1] if stack else None
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        if rec is not None:
            stack.append(name)
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rec is not None:
                stack.pop()
                rec["spans"].append((name, parent, t0, t1))
            with _LOCK:
                tot = _SPANS.setdefault(name, [0, 0.0])
                tot[0] += 1
                tot[1] += t1 - t0


@contextlib.contextmanager
def solve_record(kind: str):
    """The root of one solve on this thread: opens a record ``{"id",
    "kind", "spans", "counts"}`` and a root span named ``kind``; when it
    closes the record joins the ring that :func:`recent` reads.  Opened
    inside another solve's record (an engine that calls another), it is a
    span of that record and no record of its own."""
    if getattr(_LOCAL, "record", None) is not None:
        with trace_span(kind):
            yield _LOCAL.record
        return
    rec = {"id": next(_IDS), "kind": kind, "spans": [], "counts": {}}
    _LOCAL.record, _LOCAL.stack = rec, []
    try:
        with trace_span(kind):
            yield rec
    finally:
        _LOCAL.record = None
        with _LOCK:
            _RECENT.append(rec)


def recorded(kind: str):
    """Decorator: every call of the function is a :func:`solve_record`
    of ``kind``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with solve_record(kind):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to ``name`` in this thread's open solve record (none
    open: nothing)."""
    rec = getattr(_LOCAL, "record", None)
    if rec is not None:
        rec["counts"][name] = rec["counts"].get(name, 0) + n


def recent(kind: Optional[str] = None) -> List[dict]:
    """The closed solve records kept (of ``kind``, where given), oldest
    first."""
    with _LOCK:
        recs = list(_RECENT)
    return [r for r in recs if kind is None or r["kind"] == kind]


def span_stats() -> Dict[str, Dict[str, float]]:
    with _LOCK:
        totals = {name: tuple(tot) for name, tot in _SPANS.items()}
    out = {}
    for name, (n, total) in totals.items():
        out[name] = {
            "count": n,
            "total_s": round(total, 6),
            "mean_ms": round(1e3 * total / n, 3),
        }
    return out
