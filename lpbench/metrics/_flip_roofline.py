"""K3's share of its roofline where the solve tells its bound flips from its
pivots: ``roofline.batched_solve_bytes`` charges every step an instance
counts in ``pivots`` as a pivot, flips included, and so overstates the
bound of a solve that flips often.

The share covers the solve loop's own launches, in the tableau's dtype
(the note's ``tableau``): the bytes come from that loop's counts, and the
device time from K3's instantiation in that dtype alone.  A float32
solve's float64 finish (``ops/batched.py::finish_bounded_f64``) launches
K3 in float64 and counts its steps apart (``finish_steps``), so its
launches are in neither."""
from __future__ import annotations

import numpy as np

from lpbench import roofline
from lpbench.metrics._common import device_s

KERNEL = "fused_pivot_step_bounded_kernel"
# The kernel's template argument for a tableau of this many bytes an entry.
CTYPE = {4: "float", 8: "double"}


def solve_bytes(M, N, itemsize, pivots, flips, launches):
    """Bytes the ``launches`` K3 steps of one bounded solve must move, from
    each instance's steps (``pivots``, flips included) and ``flips``: an
    instance pivots in its first ``pivots[i] - flips[i]`` steps, flips in
    the next ``flips[i]`` and is charged a stopping step in every other,
    with no eligible column and no Bland tie (``roofline.step_bytes`` and
    ``state_bytes``).  Both sum per instance, so the order given to its
    pivots and flips does not change the total.  Returns ``(bytes,
    flops)``, the operations of the pivots alone."""
    pivots = np.asarray(pivots)
    true = pivots - np.asarray(flips)
    none = np.zeros(pivots.shape, bool)
    total, flops = 0, 0
    for t in range(int(launches)):
        piv = true > t
        flip = ~piv & (pivots > t)
        st = roofline.state_bytes(M, N, itemsize, piv, flip, ~(piv | flip),
                                  0, none, devex=True, bounded=True)
        total += roofline.step_bytes(M, N, itemsize, piv, flip, st)
        flops += 2 * M * N * int(piv.sum())
    return total, flops


def share(record):
    """The share in percent over the traced calls, or None where no call
    noted its flips (a program whose loop does not count them) or K3 did
    not run in the loop's dtype."""
    total, sizes = 0.0, set()
    for c in record["calls"]:
        n = c["notes"]
        if not c["traced"] or "flips" not in n or not n["bounded"]:
            continue
        _, M, N, itemsize = n["tableau"]
        nbytes, flops = solve_bytes(M, N, itemsize, n["pivots"], n["flips"],
                                    n["launches"])
        total += roofline.bound_s(nbytes, flops)[0]
        sizes.add(itemsize)
    dev = device_s(record, *(f"{KERNEL}<{CTYPE[s]}>" for s in sizes))
    return roofline.share_pct(total, dev) if total > 0 else None
