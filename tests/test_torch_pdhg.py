"""The port's PDHG solver and crossover against the JAX package.

``simplex_tpu_torch/models/pdhg.py`` and ``models/crossover.py`` against
``simplex_tpu/models/pdhg.py`` and ``crossover.py`` on the same seeded
inputs.  With JAX's power-iteration start vector put in place of the port's
draw (``_power_iter_start``), the float64 loop is iteration-equal: the same
iterations and ``converged``, x and y within 1e-9.  In float32 the matvecs
sum in another order than XLA's ``einsum``, so trajectories split and
parity is at the solve level: ``converged`` equal, objectives within
1e-3·(1+|z|).  Exact engines (crossover): the same status, z within
1e-6·(1+|z|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from _torch_parity import CPU, z_close

import simplex_tpu.models.crossover as jc
import simplex_tpu.models.pdhg as jp
from simplex_tpu.core.problem import LinearProgram as JLP

import simplex_tpu_torch.models.crossover as tc
import simplex_tpu_torch.models.pdhg as tp
from simplex_tpu_torch import SolverConfig
from simplex_tpu_torch.core.problem import LinearProgram as TLP

TCFG = SolverConfig(device=CPU)


def _batch(seed, B, m, n, feasible_at=False):
    """``tests/test_pdhg_stream.py::_mk_batch``'s batch (all ``<=``, b > 0);
    with ``feasible_at``, b = A x0 + slack as in its bounded test."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, size=(B, m, n))
    if feasible_at:
        x0 = rng.uniform(0.2, 1.5, (B, n))
        b = np.einsum("bmn,bn->bm", A, x0) + rng.uniform(0.1, 0.5, (B, m))
    else:
        b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    return c, A, b, np.full((m,), -1)


@pytest.fixture
def jax_start(monkeypatch):
    """The port's power iteration starts from JAX's draw."""
    def draw(B, n, dtype, device):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = jax.random.normal(jax.random.PRNGKey(0), (B, n), dtype=jdt)
        return torch.as_tensor(np.array(v), device=device)
    monkeypatch.setattr(tp, "_power_iter_start", draw)


def _f64(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


def test_ruiz_equilibrate_matches_jax():
    _, A, _, _ = _batch(1, 6, 9, 7)
    A = A * np.logspace(-2, 2, 9)[None, :, None]
    with jax.enable_x64(True):
        ref = [np.asarray(a) for a in jp._ruiz_equilibrate(jnp.asarray(A))]
    got = tp._ruiz_equilibrate(torch.as_tensor(A))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-13, atol=0)


def test_power_iteration_matches_jax(jax_start):
    _, A, _, _ = _batch(2, 6, 9, 7)
    with jax.enable_x64(True):
        ref = np.asarray(jp._power_iter_sigma_max(jnp.asarray(A)))
        got = tp._power_iter_sigma_max(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, np.linalg.norm(A, 2, axis=(1, 2)),
                               rtol=1e-6)


def test_start_vector_is_seeded():
    a = tp._power_iter_start(4, 5, torch.float32, "cpu")
    b = tp._power_iter_start(4, 5, torch.float32, "cpu")
    assert torch.equal(a, b) and a.shape == (4, 5)


@pytest.mark.parametrize("bounded", [False, True])
def test_pdhg_solve_is_iteration_equal_in_float64(jax_start, bounded):
    c, A, b, _ = _batch(3, 8, 10, 6, feasible_at=bounded)
    is_eq = np.zeros(b.shape, bool)
    is_eq[:, 0] = True                        # one free dual per instance
    ub = None
    if bounded:
        rng = np.random.default_rng(4)
        ub = np.where(rng.random((8, 6)) < 0.7, rng.uniform(0.5, 1.8, (8, 6)),
                      np.inf)
    kw = dict(max_iters=3000, tol=1e-6, bounded=bounded)
    with jax.enable_x64(True):
        ref = jp._pdhg_solve(jnp.asarray(A), jnp.asarray(b),
                             jnp.asarray(-c), jnp.asarray(is_eq),
                             None if ub is None else jnp.asarray(ub), **kw)
        ref = [np.asarray(r) for r in ref]
        got = tp._pdhg_solve(*_f64(A, b, -c), torch.as_tensor(is_eq),
                             None if ub is None else torch.as_tensor(ub),
                             **kw)
    assert got[6] == int(ref[6])
    np.testing.assert_array_equal(got[5].numpy(), ref[5])
    assert 0 < ref[5].sum() < 8 and ref[6] > 100
    for r, g in zip(ref[:5], got[:5]):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-9)


def test_pdhg_loop_stops_at_the_cap_inside_a_chunk():
    c, A, b, ops = _batch(5, 4, 8, 5)
    before = tp.STATE_READS
    res = tp.PdhgSolver(tol=1e-12, max_iters=97, device=CPU).solve_arrays(
        c, A, b, ops, maximize=True)
    assert res.iters == 97 and not res.converged.any()
    assert tp.STATE_READS - before == 2       # checks at 40 and 80
    ref = jp.PdhgSolver(tol=1e-12, max_iters=97).solve_arrays(
        c, A, b, ops, maximize=True)
    assert ref.iters == 97


@pytest.mark.parametrize("seed,maximize,tol", [(7, True, 1e-5),
                                                (8, False, 1e-4)])
def test_pdhg_float32_agrees_with_jax(jax_start, seed, maximize, tol):
    c, A, b, ops = _batch(seed, 16, 10, 6)
    ops = ops.copy()
    ops[1] = 1                                # a >= row, negated to <=
    b[:, 1] = 0.2
    ref = jp.PdhgSolver(tol=tol, max_iters=20000).solve_arrays(
        c, A, b, ops, maximize=maximize)
    got = tp.PdhgSolver(tol=tol, max_iters=20000, device=CPU).solve_arrays(
        c, A, b, ops, maximize=maximize)
    np.testing.assert_array_equal(got.converged, ref.converged)
    assert got.converged.sum() >= 12
    ok = got.converged
    assert np.all(np.abs(got.objective[ok] - ref.objective[ok])
                  <= 1e-3 * (1.0 + np.abs(ref.objective[ok])))


def test_bounded_pdhg_agrees_with_jax_and_highs(jax_start):
    c, A, b, ops = _batch(8, 24, 10, 8, feasible_at=True)
    ub = np.where(np.random.default_rng(9).random(8) < 0.7,
                  np.random.default_rng(10).uniform(0.5, 1.8, size=8),
                  np.inf)
    ref = jp.PdhgSolver(tol=1e-5, max_iters=40000).solve_arrays(
        c, A, b, ops, maximize=True, ub=ub)
    got = tp.PdhgSolver(tol=1e-5, max_iters=40000, device=CPU).solve_arrays(
        c, A, b, ops, maximize=True, ub=ub)
    np.testing.assert_array_equal(got.converged, ref.converged)
    bounds = [(0.0, None if np.isinf(u) else u) for u in ub]
    for i in np.nonzero(got.converged)[0][:8]:
        h = linprog(-c[i], A_ub=A[i], b_ub=b[i], bounds=bounds,
                    method="highs")
        assert abs(got.objective[i] + h.fun) <= 2e-3 * (1 + abs(h.fun))
        assert abs(got.objective[i] - ref.objective[i]) <= 1e-3 * (
            1 + abs(ref.objective[i]))
        assert np.all(got.x[i] <= ub + 1e-4)
    with pytest.raises(ValueError):
        tp.PdhgSolver(device=CPU).solve_arrays(c, A, b, ops, ub=-np.ones(8))


def test_stream_matches_the_solver_batch_by_batch():
    batches = [_batch(20 + k, 8, 10, 6) for k in range(3)]
    streamed = list(tp.solve_arrays_stream(
        iter(batches), tol=1e-4, max_iters=20000, maximize=True,
        device=CPU))
    assert len(streamed) == 3
    solver = tp.PdhgSolver(tol=1e-4, max_iters=20000, device=CPU)
    for res, batch in zip(streamed, batches):
        ref = solver.solve_arrays(*batch, maximize=True)
        np.testing.assert_array_equal(res.converged, ref.converged)
        np.testing.assert_array_equal(res.x, ref.x)
        assert res.iters == ref.iters and res.exact is None
    assert list(tp.solve_arrays_stream(iter([]), device=CPU)) == []


def test_stream_rejects_a_config_on_another_device():
    with pytest.raises(ValueError, match="device"):
        next(tp.solve_arrays_stream(iter([_batch(1, 2, 3, 2)]),
                                    config=SolverConfig(device="cuda"),
                                    device=CPU))


def _exact_same(ref, got):
    assert sorted(ref) == sorted(got)
    for i in ref:
        assert got[i].status == ref[i].status
        if ref[i].success:
            assert z_close(ref[i].z, got[i].z)


@pytest.mark.parametrize("mode,B,max_iters", [
    ("all", 8, 60000), ("unconverged", 4, 50), ("unconverged", 96, 10)])
def test_stream_crossover_agrees_with_jax(mode, B, max_iters):
    """Both crossover modes; 96 unconverged instances take the batched
    path (``_crossover_via_batched``, padded to 256), the others the
    per-instance ``crossover_batch``."""
    batches = [_batch(31, B, 8, 5)]
    kw = dict(tol=1e-5 if mode == "all" else 1e-9, max_iters=max_iters,
              maximize=True, crossover=mode)
    ref = list(jp.solve_arrays_stream(iter(batches), **kw))[0]
    got = list(tp.solve_arrays_stream(iter(batches), device=CPU, **kw))[0]
    _exact_same(ref.exact, got.exact)
    assert len(got.exact) >= (64 if B == 96 else 1)
    assert np.all(got.converged)
    c, A, b, _ = batches[0]
    for i in list(got.exact)[:6]:
        h = linprog(-c[i], A_ub=A[i], b_ub=b[i], method="highs")
        assert z_close(-h.fun, got.exact[i].z)
        assert z_close(-h.fun, got.objective[i])


def test_bounded_stream_recovery_agrees_with_jax():
    c, A, b, ops = _batch(8, 24, 10, 8, feasible_at=True)
    ub = np.where(np.random.default_rng(2).random(8) < 0.7,
                  np.random.default_rng(3).uniform(0.5, 1.8, size=8),
                  np.inf)
    kw = dict(tol=1e-9, max_iters=30, maximize=True,
              crossover="unconverged", ub=ub)
    ref = list(jp.solve_arrays_stream(iter([(c, A, b, ops)]), **kw))[0]
    got = list(tp.solve_arrays_stream(iter([(c, A, b, ops)]), device=CPU,
                                      **kw))[0]
    _exact_same(ref.exact, got.exact)
    assert np.all(got.converged) and len(got.exact) == 24


def test_crossover_lp_agrees_with_jax():
    """A near-optimal point through ``crossover_lp``: classic (dual
    reoptimize from the guessed basis), bounded (the revised engine's warm
    start) and an EQ-heavy LP whose guess is singular."""
    c, A, b, ops = _batch(17, 1, 12, 8)
    lp_kw = dict(c=c[0], A=A[0], b=b[0], ops=ops, maximize=True)
    h = linprog(-c[0], A_ub=A[0], b_ub=b[0], method="highs")
    x = h.x + 1e-4
    cases = [(lp_kw, x)]
    ub = np.where(np.arange(8) % 2 == 0, 0.8, np.inf)
    cases.append((dict(lp_kw, ub=ub), np.minimum(x, ub)))
    cases.append((dict(c=[1.0, 2.0], A=[[1.0, 1.0], [1.0, -1.0],
                                         [2.0, 2.0]],
                       b=[3.0, 1.0, 6.0], ops=[0, 0, 0], maximize=False),
                  np.array([2.0, 1.0])))
    for kw, xa in cases:
        ref = jc.crossover_lp(JLP(**kw), xa)
        got = tc.crossover_lp(TLP(**kw), xa, TCFG)
        assert got.status == ref.status == 0
        assert z_close(ref.z, got.z)


def test_crossover_batch_agrees_with_jax():
    c, A, b, ops = _batch(12, 6, 8, 5)
    x = np.stack([linprog(-c[i], A_ub=A[i], b_ub=b[i], method="highs").x
                  for i in range(6)]) * 0.98
    ref = jc.crossover_batch(c, A, b, ops, True, x, indices=[0, 2, 5])
    got = tc.crossover_batch(c, A, b, ops, True, x, indices=[0, 2, 5],
                             config=TCFG)
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert g.status == r.status == 0 and z_close(r.z, g.z)
