"""The generator of the multidimensional knapsack traffic: LP relaxations
``max c.x  s.t.  A x <= b,  0 <= x <= 1`` of Chu & Beasley's instances
("A genetic algorithm for the multidimensional knapsack problem", Journal
of Heuristics 4 (1998) 63-86; OR-Library ``mknapcb1``-``mknapcb9``), drawn
from the parameters of a traffic file, ``traffic/<name>.json``:

* ``batch``: LPs a call;
* from the configuration: ``m``, ``n`` (constraints and variables) and
  ``dtype`` (the arrays' type);
* ``weights``: ``[lo, hi]``, weights a_ij drawn as integers from U{lo..hi};
* ``tightness``: the values of alpha, one drawn uniformly per LP;
* ``profit_spread``: the factor of q_j in c_j;
* ``ub``: the upper bound of every variable;
* ``pool``: how many distinct inputs a run makes in set-up and cycles.

The law is the paper's: b_i = alpha sum_j a_ij, and profits correlated with
the weights, c_j = sum_i a_ij / m + spread q_j with q_j from U(0, 1).  The
OR-Library files hold integers, so b and c are cut to their integer parts
(``numpy.floor``); every value is then exact in float32.

Item k of a run with seed s is drawn from ``numpy.random.default_rng([s,
k])``, as ``generate.py`` draws it: one seed gives the same inputs on any
machine, and every seed the same sizes.  The draws, in order: the weights,
alpha, q.
"""
from __future__ import annotations

import concurrent.futures

import numpy as np


def item(traffic: dict, seed: int, k: int) -> dict:
    """Input ``k`` of a run: ``c`` (B, n), ``A`` (B, m, n), ``b`` (B, m)
    and ``ub`` (B, n) as numpy arrays of ``traffic["dtype"]``, and
    ``alpha`` (B,) float64, the tightness each LP was drawn with."""
    rng = np.random.default_rng([int(seed), int(k)])
    B, m, n = traffic["batch"], traffic["m"], traffic["n"]
    dt = np.dtype(traffic["dtype"])
    lo, hi = traffic["weights"]
    W = rng.integers(lo, hi + 1, size=(B, m, n), dtype=np.int16)
    alpha = rng.choice(np.asarray(traffic["tightness"], np.float64), size=B)
    q = rng.random((B, n))
    b = np.floor(alpha[:, None] * W.sum(axis=2, dtype=np.int64))
    c = np.floor(W.sum(axis=1, dtype=np.int64) / m
                 + traffic["profit_spread"] * q)
    return {"c": c.astype(dt), "A": W.astype(dt), "b": b.astype(dt),
            "ub": np.full((B, n), traffic["ub"], dt), "alpha": alpha}


def pool(traffic: dict, seed: int, size: int = None) -> list:
    """The ``pool`` inputs a run cycles through, drawn on a thread each:
    every item has its own generator, so the threads change no value, and
    numpy's draws, sums and casts release the GIL, so the set-up draws
    the pool in about the time of one item."""
    ks = range(size or traffic["pool"])
    with concurrent.futures.ThreadPoolExecutor(len(ks)) as ex:
        return list(ex.map(lambda k: item(traffic, seed, k), ks))
