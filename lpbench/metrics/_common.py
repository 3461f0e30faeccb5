"""What the metric readers share: host seconds per call of a span, and the
device seconds of the kernels whose names hold a given part."""
from __future__ import annotations


def per_call(record, span):
    """Mean host seconds per timed call spent in ``span`` (summed over
    its calls inside one), or None where no call entered it."""
    calls = record["calls"]
    hit = [sum(c["spans"][span]) for c in calls if span in c["spans"]]
    if not calls or not hit:
        return None
    return sum(hit) / len(calls)


def device_s(record, *parts):
    prof = record.get("profile")
    if not prof:
        return 0.0
    return sum(s for name, s in prof["kernels"].items()
               if any(p in name for p in parts))


def idle_pct(record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
