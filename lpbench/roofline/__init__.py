"""Published peaks of one NVIDIA H100 and the bytes each kernel of the port
must move, from shapes and from what a solve reports about itself.

The peaks and ``bound_s`` are ``chip_smoke.py``'s (``HBM_BYTES_PER_S``,
``F32_FLOPS``, ``_bound_ms``); ``step_bytes`` and ``state_bytes`` are its
``_step_bytes`` and ``_state_bytes``, copied so that a later change to the
program cannot change the yardstick.  A roofline share is the least time
the card could take (the larger of bytes over the memory peak and
operations over the float32 peak) divided by the kernel's device time.
"""
from __future__ import annotations

import numpy as np

# H100 SXM data sheet, dense rates: HBM3 bandwidth and float32 outside the
# tensor cores.  Both assume the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes, flops):
    """The least seconds the card could take: (seconds, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_bytes(M, N, itemsize, pivot, flip, state_bytes):
    """Bytes one batched step (K2 or K3) must move: a pivoting instance
    reads and writes its whole M x N tableau; a flipping one reads its
    objective row, the entering column and the RHS column and writes the
    RHS column; any other reads what decides that it stops (the objective
    row, the entering column and the RHS column).  ``pivot`` and ``flip``
    are bool arrays over the instances; ``state_bytes`` is every other
    input read once and output written once."""
    n_piv = int(np.sum(pivot))
    n_flip = int(np.sum(flip))
    n_rest = np.size(pivot) - n_piv - n_flip
    elems = n_piv * 2 * M * N + n_flip * (N + 3 * M) + n_rest * (N + 2 * M)
    return elems * itemsize + state_bytes


def state_bytes(M, N, itemsize, pivot, flip, optimal, eligible, bland,
                devex, bounded, art_rows=None):
    """Bytes of every input but the tableau that one K2 or K3 step must
    read once and every output it must write once (arrays over the
    instances; ``eligible`` counts the columns pricing finds eligible):

    * every instance: phase, status and bland (9 B), the mask of its own
      phase (N), s, r and the three flags (11 B);
    * Devex: the weights of the eligible columns, or on a pivot all N
      lanes read and written;
    * the basis: the row, for Bland's tie (not optimal); else basis[r] on
      a pivot (the leaving column); basis[r] written on a pivot;
    * bounded (K3): at_upper read (N-1), ub[s], ub_B read (M-1); on a pivot
      ub_B[r] and at_upper of the leaving and the entering column written;
      on a flip at_upper[s];
    * ``art_rows`` (K3 with art-exit rows) is_art_row read (M-1); on a
      pivot art_mask[s] read and is_art_row[r] written.
    """
    R = M - 1
    piv = np.asarray(pivot, np.int64)
    flp = np.asarray(flip, np.int64)
    eligible = np.asarray(eligible, np.int64)
    per = 9 + N + 11 + 4 * piv
    if devex:
        per = per + itemsize * (eligible * (1 - piv) + 2 * N * piv)
    leaving = 4 * piv if devex or bounded else 0 * piv
    not_opt = np.asarray(bland, bool) & ~np.asarray(optimal, bool)
    per = per + not_opt.astype(np.int64) * (4 * R - leaving) + leaving
    if bounded:
        per = per + (N - 1) + itemsize * (1 + R) + (itemsize + 2) * piv + flp
    if art_rows is not None:
        per = per + R * np.asarray(art_rows, np.int64) + 2 * piv
    return int(np.sum(per))


def batched_solve_bytes(M, N, itemsize, pivots, launches, bounded):
    """Bytes the ``launches`` steps of one batched solve must move, from
    each instance's pivot count alone: an instance pivots in the first
    ``pivots[i]`` steps and is charged a stopping step in every other, with
    no eligible column, no Bland tie and no flip.  A step that cannot be
    told from outside (a bound flip, a Devex read of eligible weights) is
    so counted as the smaller one, and the share is never overstated.
    Returns ``(bytes, flops)``."""
    pivots = np.asarray(pivots)
    total, flops = 0, 0
    none = np.zeros(pivots.shape, bool)
    for t in range(int(launches)):
        piv = pivots > t
        st = state_bytes(M, N, itemsize, piv, none, ~piv, 0, none,
                         devex=True, bounded=bounded)
        total += step_bytes(M, N, itemsize, piv, none, st)
        flops += 2 * M * N * int(piv.sum())
    return total, flops


def k1_pivot_bytes(R, W, itemsize):
    """Bytes one K1 pivot must move: the R x W tableau read and written
    once.  Returns ``(bytes, flops)``."""
    return 2 * R * W * itemsize, 2 * R * W


def share_pct(bound_seconds, device_seconds):
    """A roofline share in percent, or None where the kernel did not run."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds
