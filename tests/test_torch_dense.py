"""``simplex_tpu_torch.solve_lp`` against ``simplex_tpu.solve_lp``.

The solve-level gate: the same status on every LP and, where optimal, the
certified objective within 1e-6·(1+|z|).  Pivot counts may differ: float32
trajectories split on near-ties.
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import (ANCHORS, ANCHOR_Z, CPU, bench_dense_lp, seeded_lp,
                           z_close)

import simplex_tpu as jx
import simplex_tpu_torch as pt
from simplex_tpu_torch.models import dense as t_dense

CFG = pt.SolverConfig(device=CPU)


def _both(kw):
    return (jx.solve_lp(jx.LinearProgram(**kw)),
            pt.solve_lp(pt.LinearProgram(**kw), CFG))


def _assert_parity(a, b):
    assert b.status == a.status
    assert b.success == a.success
    if a.success:
        assert z_close(a.z, b.z), (a.z, b.z)
        assert b.x.shape == a.x.shape and np.all(np.isfinite(b.x))


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_anchor(i):
    a, b = _both(ANCHORS[i])
    _assert_parity(a, b)
    assert round(b.z, 4) == ANCHOR_Z[i]
    np.testing.assert_allclose(b.duals, a.duals, atol=1e-9)
    np.testing.assert_allclose(b.reduced_costs, a.reduced_costs, atol=1e-9)


@pytest.mark.parametrize("seed", range(20))
def test_seeded_lp(seed):
    _assert_parity(*_both(seeded_lp(seed)))


def _special_lps():
    rng = np.random.default_rng(5)
    kw = seeded_lp(30)
    # Upper bounds above the point that makes the rows feasible.
    yield "bounds", dict(kw, ub=rng.uniform(2.0, 3.0, size=kw["c"].size))
    yield "free", dict(c=[1.0, -2.0], A=[[1.0, 1.0], [1.0, -1.0]],
                       b=[4.0, 1.0], ops=[-1, -1], maximize=True,
                       free=[False, True])
    yield "infeasible", dict(c=[1.0, 1.0], A=[[1.0, 1.0], [1.0, 1.0]],
                             b=[4.0, 6.0], ops=[-1, 1], maximize=True)
    yield "unbounded", dict(c=[1.0, 2.0], A=[[1.0, -1.0]], b=[2.0],
                            ops=[-1], maximize=True)
    # Rows and columns rescaled by up to 1e±3 (an equivalent LP), so the
    # Ruiz equilibration path runs.
    kw = seeded_lp(31)
    row = 10.0 ** rng.integers(-3, 4, size=kw["b"].size)
    col = 10.0 ** rng.integers(-3, 4, size=kw["c"].size)
    yield "badly_scaled", dict(kw, A=row[:, None] * kw["A"] * col[None, :],
                               b=row * kw["b"], c=kw["c"] * col)


@pytest.mark.parametrize("name", [n for n, _ in _special_lps()])
def test_lowering_and_verdict_paths(name):
    kw = dict(_special_lps())[name]
    a, b = _both(kw)
    _assert_parity(a, b)
    assert b.status == {"infeasible": 2, "unbounded": 3}.get(name, 0)


def test_bench_dense_generator_200():
    a, b = _both(bench_dense_lp(200))
    _assert_parity(a, b)
    assert b.status == 0 and not b.escalated


def test_warm_start_resumes_from_a_basis():
    kw = seeded_lp(2)
    first = pt.solve_lp(pt.LinearProgram(**kw),
                        dataclasses.replace(CFG, presolve=False))
    again = pt.solve_lp(pt.LinearProgram(**kw),
                        dataclasses.replace(CFG, presolve=False),
                        warm_basis=first.basis)
    assert again.status == 0 and z_close(first.z, again.z)
    assert again.nit <= first.nit


def test_host_exact_solve_matches():
    kw = seeded_lp(4)
    a = jx.models.dense.solve_lp_host_exact(jx.LinearProgram(**kw))
    b = t_dense.solve_lp_host_exact(pt.LinearProgram(**kw), CFG)
    _assert_parity(a, b)
