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


def z_close(z_ref, z_port) -> bool:
    """The solve-level objective gate: within 1e-6·(1+|z|)."""
    return abs(z_ref - z_port) <= 1e-6 * (1.0 + abs(z_ref))
