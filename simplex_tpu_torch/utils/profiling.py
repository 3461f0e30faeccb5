"""Tracing, metrics, and benchmark helpers (port of
``simplex_tpu/utils/profiling.py``).

* :class:`SolveRecord` — structured per-solve record (problem shape,
  engine, pivots, status, wall time) with a JSONL sink;
* :func:`trace_span` — context manager emitting a ``torch.profiler``
  annotation (``record_function``, visible in a profiler trace) plus wall
  time;
* :func:`simple_timeit` — steady-state timing: warm-up first, then timed
  runs.  Where the output is a CUDA tensor the runs are timed by CUDA
  events on its device (the host returns before the card finishes, so the
  host clock alone would time the enqueue); otherwise by the host clock.

:class:`SolveRecord`, :class:`MetricsLog`, :data:`DEFAULT_METRICS` (the
same ``SIMPLEX_TPU_METRICS_FILE`` variable) and :func:`span_stats` are as in
the JAX module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

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


@contextlib.contextmanager
def trace_span(name: str):
    """torch.profiler annotation + wall-clock span."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _SPANS.setdefault(name, []).append(dt)


_SPANS: Dict[str, List[float]] = {}


def span_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, times in _SPANS.items():
        out[name] = {
            "count": len(times),
            "total_s": round(sum(times), 6),
            "mean_ms": round(1e3 * sum(times) / len(times), 3),
        }
    return out


def _cuda_device(out) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``out`` (a tensor, or lists,
    tuples and dicts of them), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            dev = _cuda_device(item)
            if dev is not None:
                return dev
    return None


def simple_timeit(fn: Callable, *args, iters: int = 20,
                  warmup: int = 2) -> Dict[str, float]:
    """Steady-state seconds a call of ``fn(*args)``, warm-up excluded.

    The warm-up's output says where to wait: a CUDA tensor in it puts the
    timed calls between two CUDA events on its device; otherwise they are
    timed by the host clock.
    """
    if warmup < 1:
        raise ValueError("warmup must be >= 1: the output of a warm-up call "
                         "says which device to time")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _cuda_device(out)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        dt = (time.perf_counter() - t0) / iters
        return {"mean_s": dt, "iters": iters}
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    return {"mean_s": dt, "iters": iters}
