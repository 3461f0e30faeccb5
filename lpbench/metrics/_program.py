"""What the readers of the program's own spans and counters share
(``simplex_tpu_torch/utils/profiling.py``): the solve records of the
window's calls, and the process's span totals.  A program without solve
records (one older than its spans) gives None: the metric is left out."""
from __future__ import annotations

# The root span of one call of the batched entry.
BATCHED = "batched.solve_arrays"


def _profiling():
    try:
        from simplex_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recent") else None


def window_records(record, kind: str = BATCHED):
    """The solve records of the window's calls: the last ``len(calls)``
    records of ``kind`` (the warm calls come before them and nothing
    solves after them), or None where fewer are kept."""
    prof = _profiling()
    n = len(record["calls"])
    if prof is None or n == 0:
        return None
    recs = prof.recent(kind)
    return recs[-n:] if len(recs) >= n else None


def span_per_call(record, name: str):
    """Mean host seconds per call in the program's span ``name`` (summed
    over its spans inside one call), or None where no call entered it."""
    recs = window_records(record)
    if recs is None:
        return None
    hits = [end - start for r in recs for span, _, start, end in r["spans"]
            if span == name]
    return sum(hits) / len(recs) if hits else None


def count_per_call(record, name: str):
    """Mean per call of the solve records' count ``name``."""
    recs = window_records(record)
    if recs is None:
        return None
    return sum(r["counts"].get(name, 0) for r in recs) / len(recs)


def span_total(name: str):
    """The process's host seconds in the program's span ``name``."""
    prof = _profiling()
    if prof is None:
        return None
    return prof.span_stats().get(name, {}).get("total_s", 0.0)
