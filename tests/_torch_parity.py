"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*.py).

Every input is made from a seed with numpy and handed to both packages, the
JAX reference (``simplex_tpu``) and the port (``simplex_tpu_torch``), so a
difference in results is a difference in the code.  Torch runs on one CPU
thread: the suite runs several pytest workers side by side.
"""
import numpy as np
import torch

torch.set_num_threads(1)

CPU = "cpu"

# The three report anchors, as LinearProgram keyword arguments, with their
# true optima (scipy HiGHS on the same data).
ANCHORS = [
    dict(c=[15.0, 18.0], A=[[4.0, 2.0], [2.0, 6.0], [20.0, 28.0]],
         b=[2000.0, 2400.0, 14000.0], ops=[-1, -1, -1], maximize=True),
    dict(c=[50.0, 80.0], A=[[4.0, 1.0], [1.0, 6.0], [4.0, 6.0]],
         b=[4.0, 6.0, 12.0], ops=[1, 1, 1], maximize=False),
    dict(c=[2.0, 3.0], A=[[1.0, 1.0], [2.0, 1.0]], b=[5.0, 8.0],
         ops=[1, 1], maximize=False),
]
ANCHOR_Z = [9833.3333, 153.3333, 10.0]


def anchor_wrapper(kw):
    """An anchor as the report's ``problema_definicion`` wrapper dict."""
    op_str = {-1: "<=", 0: "=", 1: ">="}
    names = [f"x{j + 1}" for j in range(len(kw["c"]))]
    return {"problema_definicion": {
        "funcion_objetivo": {
            "type": "maximize" if kw["maximize"] else "minimize",
            "coefficients": dict(zip(names, kw["c"]))},
        "restricciones": [
            {"coefficients": dict(zip(names, row)),
             "operator": op_str[op], "rhs": rhs}
            for row, op, rhs in zip(kw["A"], kw["ops"], kw["b"])],
    }}


def seeded_lp(seed: int, max_m: int = 40, max_n: int = 40):
    """A small LP with mixed ``<=`` / ``=`` / ``>=`` rows, feasible by
    construction (the rows hold at a random nonnegative point); the cost
    signs are mixed, so some instances are unbounded."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, max_m))
    n = int(rng.integers(2, max_n))
    A = rng.uniform(-1, 3, size=(m, n)).round(2)
    x0 = rng.uniform(0, 2, size=n)
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.15, 0.25])
    b = A @ x0
    b = np.where(ops == -1, b + rng.uniform(0, 2, m),
                 np.where(ops == 1, b - rng.uniform(0, 2, m), b))
    c = rng.uniform(-1, 2, size=n).round(2)
    return dict(c=c, A=A, b=b, ops=ops, maximize=bool(rng.integers(0, 2)))


def bench_dense_lp(size: int):
    """The dense LP of ``bench.py::bench_dense_solve`` at ``size``."""
    rng = np.random.default_rng(0)
    m = n = size
    A = rng.uniform(0.05, 1.0, size=(m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    return dict(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True)


# The mixed operators of tests/test_pallas_batched.py: >= and = rows send
# the instances through phase 1.
MIXED_OPS = np.array([-1, -1, -1, -1, 1, 1, 0, 0, -1])


def random_batch(seed: int, B: int = 12, m: int = 9, n: int = 13, ops=None):
    """``(c, A, b, ops)`` of a uniform batch, as
    ``tests/test_pallas_batched.py::_random_batch`` makes it (dense positive
    rows, b > 0, so every ``<=`` batch is feasible and bounded)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 2.0, (B, m, n))
    c = rng.uniform(0.5, 3.0, (B, n))
    b = rng.uniform(5.0, 25.0, (B, m))
    if ops is None:
        ops = np.full(m, -1)
    return c, A, b, np.asarray(ops)


def ulps(a, b) -> int:
    """The largest distance between two float arrays of one dtype, in units
    in the last place (0 where they are bit-identical)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.dtype.kind == "f"
    ib = np.int32 if a.dtype == np.float32 else np.int64
    top = np.iinfo(ib).max

    def key(x):
        i = np.ascontiguousarray(x).view(ib).astype(np.int64)
        return np.where(i < 0, -(i & top), i)
    return int(np.abs(key(a) - key(b)).max(initial=0))


def z_close(z_ref, z_port) -> bool:
    """The solve-level objective gate: within 1e-6·(1+|z|)."""
    return abs(z_ref - z_port) <= 1e-6 * (1.0 + abs(z_ref))


def bounded_lp(seed: int):
    """``tests/test_bounds.py::_random_bounded_lp`` as LinearProgram keyword
    arguments: mixed rows that hold at a random point, and per variable one
    of the bound kinds [0, inf), free, a box, (-inf, u] and [l, inf) with l
    possibly negative."""
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(3, 9)), int(rng.integers(3, 11))
    A = rng.normal(size=(m, n)).round(2)
    x0 = rng.uniform(-1, 3, size=n)
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3]).astype(np.int8)
    slack = rng.uniform(0.1, 1.0, size=m)
    b = A @ x0 + np.where(ops == -1, slack,
                          np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=n).round(2)
    kind = rng.integers(0, 5, size=n)
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    for j in range(n):
        if kind[j] == 1:
            lb[j] = -np.inf
        elif kind[j] == 2:
            lb[j] = round(x0[j] - rng.uniform(0, 2), 2)
            ub[j] = round(x0[j] + rng.uniform(0, 2), 2)
        elif kind[j] == 3:
            lb[j], ub[j] = -np.inf, round(x0[j] + rng.uniform(0, 2), 2)
        elif kind[j] == 4:
            lb[j] = round(x0[j] - rng.uniform(0, 2), 2)
    return dict(c=c, A=A, b=b, ops=ops, maximize=bool(rng.integers(0, 2)),
                lb=lb, ub=ub)


def random_ub(seed: int, shape, lo: float, hi: float, frac: float = 1.0):
    """Upper bounds from U(lo, hi) on a ``frac`` share of the entries, +inf
    on the rest."""
    rng = np.random.default_rng(seed)
    ub = rng.uniform(lo, hi, shape)
    return np.where(rng.random(shape) < frac, ub, np.inf)
