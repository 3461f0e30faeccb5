"""K2's or K3's share of its roofline over the window: the bytes every
launch must move (``roofline.batched_solve_bytes``, from each instance's
pivot count) over the kernel's device time from the profiler."""
from __future__ import annotations

from lpbench import roofline
from lpbench.metrics._common import device_s


def share(record, bounded: bool, kernel: str):
    total = 0.0
    for c in record["calls"]:
        n = c["notes"]
        if not c["traced"] or "tableau" not in n or n["bounded"] != bounded:
            continue
        _, M, N, itemsize = n["tableau"]
        nbytes, flops = roofline.batched_solve_bytes(
            M, N, itemsize, n["pivots"], n["launches"], bounded)
        total += roofline.bound_s(nbytes, flops)[0]
    dev = device_s(record, kernel)
    return roofline.share_pct(total, dev) if total > 0 else None
