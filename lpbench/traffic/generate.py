"""The one generator of the benchmark's traffic: random dense LPs
``max c.x  s.t.  A x <= b,  0 <= x (<= ub)`` drawn from the parameters of a
traffic file, ``traffic/<name>.json``:

* ``batch``: LPs a call (a batch), or null for one ``LinearProgram`` a call;
* from the configuration: ``m``, ``n`` (rows and variables) and
  ``dtype`` (the arrays' type);
* ``A``, ``c``: ``[lo, hi]`` of a uniform draw;
* ``b``: ``{"uniform": [lo, hi]}``, ``{"uniform_times_m": [lo, hi]}``
  (U(lo m, hi m)), or ``{"feasible_point": {"x0": [lo, hi], "slack": [lo,
  hi]}}`` (b = A x0 + U(slack), x0 ~ U(x0));
* ``ub``: null, or ``{"share": p, "range": [lo, hi]}``: each variable
  bounded by U(lo, hi) with probability p, else +inf;
* ``pool``: how many distinct inputs a run makes in set-up and cycles.

Item k of a run with seed s is drawn from ``numpy.random.default_rng([s,
k])``, so one seed gives the same inputs and every seed the same sizes.
The draws follow the port's generators (``utils/solve_bench.lp_batch``,
``dense_lp``, ``utils/sharded_cards.config5_lp``) in order and law.
"""
from __future__ import annotations

import numpy as np


def _b(rng, spec, A, m):
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return rng.uniform(lo, hi, size=A.shape[:-1])
    if "uniform_times_m" in spec:
        lo, hi = spec["uniform_times_m"]
        return rng.uniform(lo * m, hi * m, size=A.shape[:-1])
    fp = spec["feasible_point"]
    x0 = rng.uniform(*fp["x0"], size=A.shape[:-2] + A.shape[-1:])
    return (np.einsum("...mn,...n->...m", A, x0)
            + rng.uniform(*fp["slack"], size=A.shape[:-1]))


def item(traffic: dict, seed: int, k: int) -> dict:
    """Input ``k`` of a run: ``c``, ``A``, ``b``, ``ub`` (or None) as numpy
    arrays, with a leading batch axis of ``traffic["batch"]`` (1 where the
    traffic sends one LP a call).  ``traffic`` holds the configuration's
    ``m``, ``n`` and ``dtype`` beside the traffic file's parameters."""
    rng = np.random.default_rng([int(seed), int(k)])
    B = traffic["batch"] or 1
    m, n = traffic["m"], traffic["n"]
    dt = np.dtype(traffic["dtype"])
    A = rng.uniform(*traffic["A"], size=(B, m, n))
    b = _b(rng, traffic["b"], A, m)
    c = rng.uniform(*traffic["c"], size=(B, n))
    ub = None
    if traffic.get("ub"):
        share, (lo, hi) = traffic["ub"]["share"], traffic["ub"]["range"]
        ub = np.where(rng.random((B, n)) < share,
                      rng.uniform(lo, hi, (B, n)), np.inf).astype(dt)
    return {"c": c.astype(dt), "A": A.astype(dt), "b": b.astype(dt),
            "ub": ub}


def pool(traffic: dict, seed: int, size: int = None) -> list:
    """The ``pool`` inputs a run cycles through."""
    return [item(traffic, seed, k) for k in range(size or traffic["pool"])]
