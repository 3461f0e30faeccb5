"""The comparison that decides ``correct``.

The program's answers are judged by what they say, against the optimum the
reference worked out from the same inputs: a returned ``x`` must be
feasible and reach the reference's objective, and returned duals must be
dual feasible and reach it too.  Judging ``x`` and the duals so, rather
than by their distance from the reference's own vertex, keeps a tie (two
vertices within the solvers' tolerances of one objective) from reading as
an error, while any answer that is infeasible or short of the optimum
fails.  Statuses and certificates are compared exactly.
"""
from __future__ import annotations

import numpy as np


def _rel(num, den):
    return num / (1.0 + np.abs(den))


def _max(a):
    a = np.asarray(a, np.float64)
    a = a[np.isfinite(a)] if a.size else a
    return float(a.max()) if a.size else 0.0


def primal_readings(lp: dict, ref: dict, out: dict) -> dict:
    """Readings of a batch of answers ``out`` (``status``, ``x``, ``z``,
    and where the program gives them ``certified``, ``escalated``,
    ``at_upper``, ``y``, ``rc``) against the reference ``ref`` on the LPs
    ``lp`` (``c``, ``A``, ``b``, ``ub``)."""
    c = np.asarray(lp["c"], np.float64)
    A = np.asarray(lp["A"], np.float64)
    b = np.asarray(lp["b"], np.float64)
    ub = lp.get("ub")
    status = np.asarray(out["status"])
    both = (status == 0) & (ref["status"] == 0)
    zr = ref["z"][both]
    x = np.asarray(out["x"], np.float64)[both]
    r = {"status_mismatch": int(np.sum(status != ref["status"])),
         "z_gap": _max(_rel(np.abs(np.asarray(out["z"])[both] - zr), zr)),
         "x_obj_gap": _max(_rel(np.abs(np.einsum("bn,bn->b", c[both], x)
                                        - zr), zr))}
    viol = np.maximum(np.einsum("bmn,bn->bm", A[both], x) - b[both], 0.0)
    v = [_rel(viol, b[both]).max(1, initial=0.0),
         np.maximum(-x, 0.0).max(1, initial=0.0)]
    if ub is not None:
        u = np.asarray(ub, np.float64)[both]
        fin = np.isfinite(u)
        over = np.where(fin, np.maximum(x - np.where(fin, u, 0.0), 0.0), 0.0)
        v.append(_rel(over, np.where(fin, u, 0.0)).max(1, initial=0.0))
    r["x_viol"] = _max(np.max(v, 0)) if both.any() else 0.0
    if "certified" in out:
        r["uncertified"] = int(np.sum((status == 0)
                                      & ~np.asarray(out["certified"], bool)))
    if "escalated" in out:
        r["escalated_share"] = float(np.mean(np.asarray(out["escalated"],
                                                        bool)))
    if out.get("at_upper") is not None and ub is not None:
        # A variable said to sit at its upper bound must sit there.
        au = np.asarray(out["at_upper"], bool)[both]
        u = np.asarray(ub, np.float64)[both]
        off = au & ~(np.abs(x - np.where(au, u, 0.0))
                     <= 1e-9 * (1.0 + np.abs(np.where(au, u, 0.0))))
        r["at_upper_off"] = int(off.sum())
    if out.get("y") is not None:
        y = np.asarray(out["y"], np.float64)[both]
        aty = np.einsum("bmn,bm->bn", A[both], y)
        scale = np.abs(c[both]).max(1)
        dviol = np.maximum(np.maximum(c[both] - aty, 0.0).max(1),
                           np.maximum(-y, 0.0).max(1))
        r["dual_viol"] = _max(_rel(dviol, scale))
        r["dual_obj_gap"] = _max(_rel(np.abs(np.einsum("bm,bm->b", b[both], y)
                                             - zr), zr))
        rc = np.asarray(out["rc"], np.float64)[both]
        r["rc_gap"] = _max(_rel(np.abs(rc - (c[both] - aty)).max(1), scale))
    return r


# How readings of several batches combine: counts add, shares and gaps
# take the worst.
_SUM = ("status_mismatch", "uncertified", "at_upper_off")


def merge(readings: list) -> dict:
    """One set of readings over many batches of answers; an escalated
    share is weighted by the batches' sizes (``_n`` in each reading)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k in _SUM:
                out[k] = out.get(k, 0) + v
            elif k != "escalated_share" and k != "_n":
                out[k] = max(out.get(k, 0.0), v)
    n = sum(r.get("_n", 1) for r in readings)
    if any("escalated_share" in r for r in readings):
        out["escalated_share"] = sum(r["escalated_share"] * r.get("_n", 1)
                                     for r in readings) / n
    return out


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: every number compared with its limit, in the
    order of ``limits``; a number above its limit, or one a limit names
    that was not read, makes the run not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
