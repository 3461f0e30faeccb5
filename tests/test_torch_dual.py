"""The port's dual reoptimizer against the JAX package on the same inputs.

Loop level, in float64: ``solve_tableau_dual`` and
``solve_tableau_dual_bounded`` of ``simplex_tpu_torch/ops/tableau.py``
against the jitted loops of ``simplex_tpu/ops/tableau.py`` from the same
start: the same status, iterations and basis (and ``at_upper``), and the
tableau within 1e-9·(1+|T|).  Solve level: ``reoptimize`` and
``DenseSimplexSolver`` against the JAX functions on the cases of
``tests/test_dense_solver.py`` and ``tests/test_bounds.py``: the same status
and z within 1e-6·(1+|z|), with the basis carried across the packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, z_close

import simplex_tpu.models.dense as jd
from simplex_tpu.config import SolverConfig as JConfig
from simplex_tpu.core.problem import LinearProgram as JLP
from simplex_tpu.core.problem import compile_standard_form, normalize_bounds
from simplex_tpu.models.revised import RevisedSimplexSolver as JRevised
from simplex_tpu.ops import tableau as jt

import simplex_tpu_torch.models.dense as td
from simplex_tpu_torch import SolverConfig
from simplex_tpu_torch.models.dense import DenseSimplexSolver
from simplex_tpu_torch.core.problem import LinearProgram as TLP
from simplex_tpu_torch.models.revised import RevisedSimplexSolver as TRevised
from simplex_tpu_torch.ops import tableau as tt

TCFG = SolverConfig(device=CPU)


def _scaled_lp(seed, m=24, n=16):
    """``tests/test_dense_solver.py::test_dual_reoptimize_devex_and_dantzig_
    agree``'s LP (rows scaled over three decades) and its shrunk RHS."""
    rng = np.random.default_rng(seed)
    rowscale = 10.0 ** rng.uniform(-1.5, 1.5, m)
    A = rng.uniform(0.1, 1.0, size=(m, n)) * rowscale[:, None]
    b = rng.uniform(m * 0.3, m * 0.6, size=m) * rowscale
    c = rng.uniform(0.1, 1.0, size=n)
    b2 = b * rng.uniform(0.6, 1.0, m)
    return dict(c=c, A=A, ops=np.full(m, -1), maximize=True), b, b2


def _bounded_lp(seed, m, n, increase):
    """``tests/test_bounds.py``'s bounded reoptimize LP (A from U(0.1, 1),
    60 % of the variables bounded) and its RHS after a shrink or, with
    ``increase``, a rise that pushes basics above their upper bounds."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.2, 1.5, size=n)
    b = A @ x0 + rng.uniform(0.05, 0.4, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    ub = np.where(rng.random(n) < 0.6, x0 * rng.uniform(0.7, 1.6, n),
                  np.inf)
    if increase:
        b2 = b * (1.0 + rng.uniform(0.05, 0.25, size=m))
    else:
        b2 = b * (1.0 - rng.uniform(0.01, 0.05, size=m))
    return dict(c=c, A=A, ops=np.full(m, -1), maximize=True, ub=ub), b, b2


@pytest.fixture
def jax_f64(monkeypatch):
    """JAX in 64-bit mode for the reference loops.  Their carry holds the
    status as int32 but updates it from the module's Python-int status
    codes, which 64-bit mode widens to int64; the codes are given here as
    int32 of the same values, so the loops trace in float64 unchanged."""
    for name in ("RUNNING", "STATUS_OPTIMAL", "STATUS_INFEASIBLE",
                 "STATUS_ITERATION_LIMIT"):
        monkeypatch.setattr(jt, name, np.int32(getattr(jt, name)))
    with jax.enable_x64(True):
        yield


def _close(ref, got):
    ref = np.asarray(ref)
    return bool(np.all(np.abs(ref - got) <= 1e-9 * (1.0 + np.abs(ref))))


def _dual_start(kw, b, b2):
    """The classic dual loop's start as ``reoptimize`` builds it: the old
    optimal basis (JAX cold solve) refactored in f64 under the new RHS."""
    lp = JLP(b=b, **kw)
    basis = jd.solve_lp(lp).basis
    lp2 = JLP(b=b2, **kw)
    row_pad, col_pad = jd._pad_plan(lp2)
    sf = compile_standard_form(lp2, row_pad=row_pad, col_pad=col_pad,
                               dtype=np.float64)
    rows = sf.tableau[:sf.m_pad]
    T_rows = np.linalg.solve(rows[:, basis], rows)
    obj = sf.obj_row_p2 - sf.obj_row_p2[basis] @ T_rows
    return np.concatenate([T_rows, obj[None]]), basis, sf.col_mask_p2


@pytest.mark.parametrize("seed,devex,refactor_every", [
    (19, True, 64), (19, False, 64), (20, True, 4), (21, False, 3)])
def test_dual_loop_equals_the_jitted_reference_in_float64(
        jax_f64, seed, devex, refactor_every):
    kw, b, b2 = _scaled_lp(seed)
    T, basis, cm = _dual_start(kw, b, b2)
    opts = dict(tol=1e-9, max_iters=500, bland_after=250,
                refactor_every=refactor_every, devex=devex)
    ref = [np.asarray(a) for a in jt.solve_tableau_dual(
        jnp.asarray(T), jnp.asarray(basis), jnp.asarray(cm), **opts)]
    got = tt.solve_tableau_dual(torch.from_numpy(T),
                                torch.from_numpy(basis.astype(np.int64)),
                                torch.from_numpy(cm), **opts)
    assert (got[2], got[3]) == (int(ref[2]), int(ref[3]))
    assert got[2] == 0 and got[3] >= 2
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    assert got[0].dtype == torch.float64 and _close(ref[0], got[0].numpy())


def _bounded_start(kw, b, b2):
    """The bounded dual loop's inputs as ``_reoptimize_bounded`` builds
    them from a JAX revised solve of the parent."""
    parent = JRevised(JConfig(presolve=False)).solve(JLP(b=b, **kw))
    lp_t, _ = normalize_bounds(JLP(b=b2, **kw))
    sf = compile_standard_form(lp_t, dtype=np.float64, bounded=True)
    n = sf.n_pad
    atu = np.asarray(parent.at_upper, bool)[:n] & np.isfinite(sf.ub_ext[:n])
    atu[parent.basis] = False
    T = np.concatenate([sf.tableau[:sf.m_pad], sf.obj_row_p2[None]])
    return T, parent.basis, sf.col_mask_p2, sf.ub_ext, atu


@pytest.mark.parametrize("seed,increase,devex,refactor_every", [
    (501, False, True, 64), (501, False, False, 1), (405, True, True, 64),
    (405, True, True, 3), (504, True, False, 2)])
def test_bounded_dual_loop_equals_the_jitted_reference_in_float64(
        jax_f64, seed, increase, devex, refactor_every):
    kw, b, b2 = _bounded_lp(seed, 24, 16, increase)
    T, basis, cm, ub, atu = _bounded_start(kw, b, b2)
    opts = dict(tol=1e-9, max_iters=500, bland_after=250,
                refactor_every=refactor_every, devex=devex)
    ref = [np.asarray(a) for a in jt.solve_tableau_dual_bounded(
        jnp.asarray(T), jnp.asarray(basis), jnp.asarray(cm),
        jnp.asarray(ub), jnp.asarray(atu), **opts)]
    got = tt.solve_tableau_dual_bounded(
        torch.from_numpy(T), torch.from_numpy(basis.astype(np.int64)),
        torch.from_numpy(cm), torch.from_numpy(ub), torch.from_numpy(atu),
        **opts)
    assert (got[3], got[4]) == (int(ref[3]), int(ref[4]))
    assert got[3] == 0 and got[4] >= 1
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    assert _close(ref[0], got[0].numpy())


def test_bounded_dual_loop_never_pivots_a_basic_column():
    """The self-pivot case: after an RHS increase a basic variable leaves
    above its upper bound, and the sign flip would let that same column
    pass the entering test at ratio 0.  The port's loop (like the JAX
    loop since the fix) leaves no column both basic and at its upper
    bound, and its verdict certifies."""
    seen_leave_up = 0
    for seed in range(500, 508):
        kw, b, b2 = _bounded_lp(seed, 20, 14, increase=True)
        T, basis, cm, ub, atu = _bounded_start(kw, b, b2)
        _, basis_t, atu_t, status, _ = tt.solve_tableau_dual_bounded(
            torch.from_numpy(T), torch.from_numpy(basis.astype(np.int64)),
            torch.from_numpy(cm), torch.from_numpy(ub),
            torch.from_numpy(atu), tol=1e-9)
        assert status == 0
        assert not np.any(atu_t.numpy()[basis_t.numpy()])
        seen_leave_up += int(atu_t.numpy().sum() > atu.sum())
    assert seen_leave_up >= 1


def _reopt_pair(kw, b2, parent_j, parent_t, cfg_j=None, cfg_t=TCFG):
    r_j = jd.reoptimize(JLP(b=b2, **kw), parent_j.basis, cfg_j or JConfig(),
                        at_upper=parent_j.at_upper)
    r_t = td.reoptimize(TLP(b=b2, **kw), parent_t.basis, cfg_t,
                        at_upper=parent_t.at_upper)
    return r_j, r_t


def _same(r_j, r_t):
    assert r_t.status == r_j.status
    if r_j.status == 0:
        assert z_close(r_j.z, r_t.z)


def test_reoptimize_after_rhs_change():
    """``tests/test_dense_solver.py::test_dual_reoptimize_after_rhs_change``
    through both packages: a tightened row (dual pivots) and a relaxed
    one (the basis stays optimal, zero pivots)."""
    kw = dict(c=[3, 5], A=[[1, 0], [0, 2], [3, 2]], ops=[-1, -1, -1],
              maximize=True)
    p_j = jd.solve_lp(JLP(b=[4, 12, 18], **kw))
    p_t = td.solve_lp(TLP(b=[4, 12, 18], **kw), TCFG)
    for b2, nit in (([4, 2, 18], None), ([5, 12, 18], 0)):
        r_j, r_t = _reopt_pair(kw, b2, p_j, p_t)
        _same(r_j, r_t)
        assert r_t.nit == r_j.nit and r_t.duals is not None
        if nit is not None:
            assert r_t.nit == nit


def test_reoptimize_random_agrees_with_jax():
    """``test_dual_reoptimize_random_agrees_with_cold``'s LPs."""
    rng = np.random.default_rng(3)
    tried = 0
    for _ in range(20):
        m, n = int(rng.integers(2, 7)), int(rng.integers(2, 7))
        kw = dict(A=rng.uniform(0.1, 1.5, size=(m, n)).round(2),
                  ops=np.full(m, -1), maximize=True)
        b = rng.uniform(1.0, 6.0, size=m).round(2)
        kw["c"] = rng.uniform(0.1, 2.0, size=n).round(2)
        p_j = jd.solve_lp(JLP(b=b, **kw))
        if not p_j.success:
            continue
        b2 = (b * rng.uniform(0.6, 1.4, size=m)).round(2)
        p_t = td.solve_lp(TLP(b=b, **kw), TCFG)
        _same(*_reopt_pair(kw, b2, p_j, p_t))
        tried += 1
    assert tried >= 15


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_reoptimize_pricing_rules_agree_with_jax(rule):
    for seed in (19, 23):
        kw, b, b2 = _scaled_lp(seed)
        p_j = jd.solve_lp(JLP(b=b, **kw))
        p_t = td.solve_lp(TLP(b=b, **kw), TCFG)
        r_j, r_t = _reopt_pair(kw, b2, p_j, p_t, JConfig(pivot_rule=rule),
                               SolverConfig(pivot_rule=rule, device=CPU))
        _same(r_j, r_t)
        assert r_t.status == 0 and r_t.nit >= 1


def test_stale_basis_falls_back_like_jax():
    kw = dict(c=[3, 5], A=[[1, 0], [0, 2], [3, 2]], b=[4, 12, 18],
              ops=[-1, -1, -1], maximize=True)
    bad = np.zeros(8, np.int32)
    r_j = jd.reoptimize(JLP(**kw), bad)
    r_t = DenseSimplexSolver(TCFG).reoptimize(TLP(**kw), bad)
    _same(r_j, r_t)
    assert abs(r_t.z - 36.0) < 1e-6


@pytest.mark.parametrize("seed,increase", [(400, False), (402, False),
                                           (500, True), (505, True)])
def test_bounded_reoptimize_agrees_with_jax(seed, increase):
    """``test_bounded_dual_reoptimize_beats_cold`` and ``..._rhs_increase_
    above_upper``'s LPs, each package from its own revised parent."""
    kw, b, b2 = _bounded_lp(seed, 24, 16, increase)
    p_j = JRevised().solve(JLP(b=b, **kw))
    p_t = TRevised(TCFG).solve(TLP(b=b, **kw))
    r_j, r_t = _reopt_pair(kw, b2, p_j, p_t)
    _same(r_j, r_t)
    assert r_t.status == 0 and r_t.at_upper is not None


def test_bounded_reoptimize_infeasible_rhs():
    rng = np.random.default_rng(55)
    m, n = 8, 5
    kw = dict(c=np.ones(n), A=rng.uniform(0.2, 1.0, size=(m, n)),
              ops=np.full(m, -1), maximize=True,
              ub=None)
    b = rng.uniform(2.0, 5.0, size=m)
    kw["ub"] = rng.uniform(0.5, 2.0, size=n)
    b2 = b.copy()
    b2[0] = -1.0
    p_j = JRevised().solve(JLP(b=b, **kw))
    p_t = TRevised(TCFG).solve(TLP(b=b, **kw))
    r_j, r_t = _reopt_pair(kw, b2, p_j, p_t)
    assert r_j.status == r_t.status == 2


def test_bounded_reoptimize_chains():
    rng = np.random.default_rng(77)
    m, n = 16, 10
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.3, 1.2, size=n)
    b = A @ x0 + rng.uniform(0.1, 0.3, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    ub = np.where(rng.random(n) < 0.7, x0 * rng.uniform(0.8, 1.5, n), np.inf)
    kw = dict(c=c, A=A, ops=np.full(m, -1), maximize=True, ub=ub)
    r_j = JRevised().solve(JLP(b=b, **kw))
    r_t = TRevised(TCFG).solve(TLP(b=b, **kw))
    for _ in range(3):
        b = b * 0.99
        r_j, r_t = _reopt_pair(kw, b, r_j, r_t)
        _same(r_j, r_t)
        assert r_t.status == 0 and r_t.at_upper is not None


@pytest.mark.parametrize("bounded", [False, True])
def test_state_carries_across_the_packages(bounded):
    """A cold solve's ``basis`` / ``at_upper`` from one package feeds the
    other's ``reoptimize``, with the JAX ``reoptimize``'s result."""
    if bounded:
        kw, b, b2 = _bounded_lp(501, 20, 14, increase=True)
        p_j = JRevised().solve(JLP(b=b, **kw))
        p_t = TRevised(TCFG).solve(TLP(b=b, **kw))
    else:
        kw, b, b2 = _scaled_lp(23)
        p_j = jd.solve_lp(JLP(b=b, **kw))
        p_t = td.solve_lp(TLP(b=b, **kw), TCFG)
    ref = jd.reoptimize(JLP(b=b2, **kw), p_j.basis, at_upper=p_j.at_upper)
    from_jax = td.reoptimize(TLP(b=b2, **kw), p_j.basis, TCFG,
                             at_upper=p_j.at_upper)
    to_jax = jd.reoptimize(JLP(b=b2, **kw), p_t.basis, at_upper=p_t.at_upper)
    for r in (from_jax, to_jax):
        _same(ref, r)
        assert r.status == 0 and (r.at_upper is not None) == bounded
