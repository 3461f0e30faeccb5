"""The bounded batched path of the port (``0 <= x <= ub`` kept native)
against the JAX package.

* solve-loop level: ``ops/batched.py::solve_tableau_batch_bounded`` of both
  packages on the same ``CompiledBatch``, for the ``phase2_only`` loop and
  the general one, backend ``"xla"`` against the port's unfused step and
  ``"pallas_interpret"`` against K3's twin (``"pallas_interpret"`` and
  ``"auto"``, which takes the twin on a CPU tensor).  Equal statuses and
  ``at_upper``; on ``phase2_only`` equal pivot counts (pivots and bound
  flips) and trip counts too; final tableaus within atol 1e-4, the
  tolerance the reference holds its own two backends to
  (tests/test_pallas_batched.py).  The general loop flips an instance to
  phase 2 at the end of a chunk (PERF.md), so its trip count may differ;
* the bounded helpers (refactor, artificial eviction, the final polish,
  extraction) on one mid-solve state;
* device assembly with bounds against ``compile_batch_uniform(ub=)``;
* solve level: ``BatchedSimplexSolver.solve_arrays(ub=)`` and
  ``solve_lp_sweep`` of both packages with certification on: equal
  statuses, z within 1e-6·(1+|z|), equal certification flags and
  ``at_upper``.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, MIXED_OPS, bounded_lp, random_batch,
                           random_ub, z_close)

import simplex_tpu_torch as pt
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.ops import batched as tops
from simplex_tpu_torch.ops import batched_kernel as bk
from simplex_tpu_torch.utils import profiling

# name -> (random_batch arguments, (seed, lo, hi) of ub, loop keywords)
LOOP_CASES = {
    "le": (dict(seed=10), (100, 0.5, 6.0), dict(phase2_only=True)),
    "le-devex": (dict(seed=13), (103, 1.0, 20.0),
                 dict(phase2_only=True, devex=True)),
    "le-bland": (dict(seed=12), (102, 0.5, 8.0),
                 dict(phase2_only=True, bland_after=0)),
    "le-refactor": (dict(seed=21, B=16, m=12, n=18), (210, 0.5, 6.0),
                    dict(phase2_only=True, refactor_every=8)),
    "mixed": (dict(seed=11, ops=MIXED_OPS), (101, 2.0, 30.0), {}),
    "mixed-devex": (dict(seed=13, ops=MIXED_OPS), (103, 1.0, 20.0),
                    dict(devex=True)),
    "mixed-refactor": (dict(seed=7, B=16, m=12, n=18,
                            ops=np.resize(MIXED_OPS, 12)), (107, 2.0, 30.0),
                       dict(refactor_every=8)),
}
# The port's backend -> the reference's backend it is held to.
BACKENDS = {"xla": "xla", "pallas_interpret": "pallas_interpret",
            "auto": "pallas_interpret"}


@functools.lru_cache(maxsize=None)
def _compiled(case):
    from simplex_tpu.models.batched import compile_batch_uniform

    batch_kw, (seed, lo, hi), _ = LOOP_CASES[case]
    c, A, b, ops = random_batch(**batch_kw)
    return compile_batch_uniform(c, A, b, ops, maximize=True,
                                 ub=random_ub(seed, c.shape, lo, hi))


def _args(cb):
    return (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2, cb.obj_row_p1,
            cb.obj_row_p2, cb.need_p1, cb.ub_ext)


@functools.lru_cache(maxsize=None)
def _jax_solve(case, backend):
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    out = jops.solve_tableau_batch_bounded(
        *[jnp.asarray(x) for x in _args(_compiled(case))], backend=backend,
        **LOOP_CASES[case][2])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_solve_loop_matches_jax(case, backend):
    kw = LOOP_CASES[case][2]
    T, basis, at_upper, status, iters, pivots = _jax_solve(
        case, BACKENDS[backend])
    st = tops.batch_state_from_compiled(_compiled(case), CPU, torch.float32)
    before = bk.LAUNCHES_K3
    out = tops.solve_tableau_batch_bounded(**st, backend=backend, **kw)
    assert bk.LAUNCHES_K3 == before        # a CPU tensor never launches K3
    np.testing.assert_array_equal(out[3].numpy(), status)
    np.testing.assert_array_equal(out[2].numpy(), at_upper)
    if kw.get("phase2_only"):
        np.testing.assert_array_equal(out[5].numpy(), pivots)
        assert out[4] == int(iters)
    np.testing.assert_allclose(out[0].numpy(), T, atol=1e-4)
    assert out[2].dtype == torch.bool and out[1].dtype == torch.int32
    # The solve loop works on its own copy: T0 stays the refactor anchor.
    assert torch.equal(st["T0"], torch.from_numpy(_compiled(case).T0))


def test_bounded_machinery_runs_in_the_loop_cases():
    """The loop cases reach optima at upper bounds and take flips: the
    ``le`` batch ends with columns at upper, all optimal."""
    _, _, at_upper, status, _, _ = _jax_solve("le", "xla")
    assert (status == 0).all() and at_upper.any()


def test_batch_state_carries_the_bounds():
    """Either package's bounded ``CompiledBatch`` gives ``ub`` in the
    tableau's dtype; a classic one gives none."""
    from simplex_tpu.models.batched import compile_batch_uniform as j_compile

    c, A, b, ops = random_batch(3, B=4)
    ub = random_ub(4, c.shape, 0.5, 3.0, frac=0.6)
    for cb in (j_compile(c, A, b, ops, True, ub=ub),
               tmb.compile_batch_uniform(c, A, b, ops, True, ub=ub)):
        for dt in (torch.float32, torch.float64):
            st = tops.batch_state_from_compiled(cb, CPU, dt)
            assert st["ub"].dtype == dt
            np.testing.assert_array_equal(st["ub"].numpy(),
                                          cb.ub_ext.astype(st["ub"].numpy()
                                                           .dtype))
    assert "ub" not in tops.batch_state_from_compiled(
        j_compile(c, A, b, ops, True), CPU, torch.float32)


# --------------------------------------------------------------------------
# The bounded helpers on one mid-solve state


@functools.lru_cache(maxsize=None)
def _mid_state():
    """The mixed bounded batch after five unfused steps (numpy): basis,
    tableau and at-upper state, with its compiled batch."""
    cb = _compiled("mixed")
    st = tops.batch_state_from_compiled(cb, CPU, torch.float32)
    T, basis = st["T0"].clone(), st["basis0"].clone()
    B, _, N = T.shape
    at_upper = torch.zeros((B, N - 1), dtype=torch.bool)
    art = torch.cat([st["col_mask_p1"] & ~st["col_mask_p2"],
                     torch.zeros((B, 1), dtype=torch.bool)], 1)
    ub_B = st["ub"].gather(1, basis.long())
    is_art_row = art.gather(1, basis.long())
    w = torch.ones((B, N - 1))
    in_p1 = st["need_p1"]
    for _ in range(5):
        col_mask = torch.where(in_p1[:, None], st["col_mask_p1"],
                               st["col_mask_p2"])
        T, basis, at_upper, w, ub_B, is_art_row, *_ = tops._bounded_step_b(
            T, basis, at_upper, col_mask, in_p1, torch.ones(B, dtype=bool),
            torch.zeros(B, dtype=bool), w, st["ub"], ub_B, is_art_row, art,
            1e-6, False, True)
    return cb, T.numpy(), basis.numpy(), at_upper.numpy()


def test_bounded_refactor_matches_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis, at_upper = _mid_state()
    assert at_upper.any()
    active = np.arange(T.shape[0]) % 4 != 1
    args = (T, basis, at_upper, cb.ub_ext, cb.T0[:, :-1, :], cb.obj_row_p1,
            active)
    ref = jops._refactor_bounded_b(*[jnp.asarray(a) for a in args])
    got = tops._refactor_bounded_b(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(got.numpy()[~active], T[~active])


def test_bounded_refactor_keeps_the_tableau_of_a_singular_basis():
    cb, T, basis, at_upper = _mid_state()
    bad = basis.copy()
    bad[0, 1] = bad[0, 0]                  # a repeated column: singular
    got = tops._refactor_bounded_b(
        *[torch.from_numpy(a) for a in (T, bad, at_upper, cb.ub_ext,
                                        cb.T0[:, :-1, :], cb.obj_row_p1,
                                        np.ones(T.shape[0], bool))])
    np.testing.assert_array_equal(got.numpy()[0], T[0])
    assert np.all(np.isfinite(got.numpy()))


def test_bounded_eviction_matches_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis, at_upper = _mid_state()
    art = np.concatenate([cb.col_mask_p1 & ~cb.col_mask_p2,
                          np.zeros((T.shape[0], 1), bool)], 1)
    args = (T, basis, at_upper, art, cb.col_mask_p2)
    jT, jb = jops._evict_artificials_bounded_b(
        *[jnp.asarray(a) for a in args], 1e-6)
    tT, tb = tops._evict_artificials_bounded_b(
        *[torch.from_numpy(a) for a in args], 1e-6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    assert not np.array_equal(np.asarray(jb), basis)   # something evicted


def test_bounded_refine_and_extract_match_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis, at_upper = _mid_state()
    args = (T, basis, cb.basis, cb.T0[:, :-1, :], cb.obj_row_p1, at_upper,
            cb.ub_ext)
    jT = jops._refine_solution_bounded_b(*[jnp.asarray(a) for a in args])
    tT = tops._refine_solution_bounded_b(*[torch.from_numpy(a)
                                           for a in args])
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    jx, jz = jops.extract_solution_batch_bounded(
        jT, jnp.asarray(basis), jnp.asarray(at_upper),
        jnp.asarray(cb.ub_ext), cb.n_vars)
    tx, tz = tops.extract_solution_batch_bounded(
        tT, torch.from_numpy(basis), torch.from_numpy(at_upper),
        torch.from_numpy(cb.ub_ext), cb.n_vars)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)


# --------------------------------------------------------------------------
# Device assembly with bounds


def test_bounded_assembly_keeps_the_structural_row_count():
    """tests/test_bounds.py::test_bounded_compile_keeps_structural_m on the
    port's device assembly: native bounds add no rows, and the port builds
    what ``compile_batch_uniform(ub=)`` builds."""
    from simplex_tpu.models.batched import compile_batch_uniform as j_compile

    B, m, n = 4, 10, 16
    rng = np.random.default_rng(3)
    A = rng.uniform(0.1, 1.0, (B, m, n))
    b = rng.uniform(5.0, 9.0, (B, m))
    c = rng.uniform(0.1, 1.0, (B, n))
    ub = np.full((B, n), 0.7)
    ub[0, 3] = 0.0                          # a fixed column
    dev = tmb.compile_batch_on_device(c, A, b, np.full(m, -1), True, ub=ub,
                                      device=CPU)
    host = j_compile(c, A, b, np.full(m, -1), True, ub=ub)
    assert dev.basis.shape[1] <= ((m + 1 + 7) // 8) * 8
    assert dev.basis.shape == host.basis.shape
    np.testing.assert_array_equal(dev.ub_ext, host.ub_ext)
    np.testing.assert_allclose(dev.T0.numpy(), host.T0, atol=1e-6)
    for f in ("col_mask_p1", "col_mask_p2"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      getattr(host, f))
    assert not dev.col_mask_p2[0, 3] and dev.col_mask_p2[1, 3]


# --------------------------------------------------------------------------
# Solve level


def _native_bounds_case():
    """tests/test_bounds.py::test_batched_native_bounds_vs_scipy's batch."""
    rng = np.random.default_rng(77)
    B, m, n = 48, 8, 6
    A = rng.normal(size=(B, m, n)).round(2)
    x0 = rng.uniform(0.2, 2.0, size=(B, n))
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.einsum("bmn,bn->bm", A, x0) + np.where(
        ops == -1, slack, np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=(B, n)).round(2)
    has_ub = rng.random((B, n)) < 0.6
    ub = np.where(has_ub,
                  x0 + rng.uniform(-0.3, 1.5, size=(B, n)).clip(0.01),
                  np.inf)
    return (c, A, b, ops), False, ub


def _solve_cases():
    yield "native", _native_bounds_case()
    # Both variables end at their upper bounds (tests/test_bounds.py:521).
    yield "all-at-upper", ((np.array([[1.0, 0.1]]), np.array([[[1.0, 1.0]]]),
                            np.array([[10.0]]), np.array([-1])), True,
           np.array([[2.0, 3.0]]))
    # A fixed column (ub = 0) beside a bounded and a free one.
    c, A, b, ops = random_batch(30, B=6, m=5, n=3)
    yield "fixed", ((c, A, b, ops), True,
                    np.tile(np.array([[0.0, 1.5, np.inf]]), (6, 1)))
    # Instance 0 infeasible (x <= 1 and x >= 3, ub 4), 1 feasible.
    yield "infeasible", ((np.array([[1.0], [1.0]]),
                          np.tile(np.array([[1.0], [1.0]])[None], (2, 1, 1)),
                          np.array([[1.0, 3.0], [5.0, 2.0]]),
                          np.array([-1, 1])), True, np.array([[4.0], [4.0]]))
    # Instance 0 unbounded (x1 unbounded above along x1 - x2 <= 1), 1
    # bounded by its ub.
    yield "unbounded", ((np.array([[1.0, 1.0], [1.0, 1.0]]),
                         np.array([[[1.0, -1.0], [-1.0, 1.0]],
                                   [[1.0, -1.0], [-1.0, 1.0]]]),
                         np.array([[1.0, 2.0], [1.0, 2.0]]),
                         np.array([-1, -1])), True,
                        np.array([[np.inf, np.inf], [3.0, 2.5]]))
    # The bench.py::bench_bounded_batched recipe at a small B.
    rng = np.random.default_rng(0)
    B, m, n = 16, 30, 50
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ub = np.where(rng.random((B, n)) < 0.6, rng.uniform(1.0, 3.0, (B, n)),
                  np.inf)
    yield "30x50", ((c, A, b, np.full(m, -1)), True, ub)


SOLVE_CASES = dict(_solve_cases())


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_arrays_with_bounds_matches_jax(case, backend):
    from simplex_tpu.config import SolverConfig as JConfig
    from simplex_tpu.models.batched import BatchedSimplexSolver as JSolver

    args, maximize, ub = SOLVE_CASES[case]
    ref = JSolver(JConfig(batched_backend=BACKENDS[backend])).solve_arrays(
        *args, maximize=maximize, ub=ub)
    got = pt.BatchedSimplexSolver(pt.SolverConfig(
        device=CPU, batched_backend=backend)).solve_arrays(
            *args, maximize=maximize, ub=ub)
    np.testing.assert_array_equal(got.status, ref.status)
    for i in np.flatnonzero(ref.status == 0):
        assert z_close(ref.z[i], got.z[i]), (i, ref.z[i], got.z[i])
    np.testing.assert_array_equal(got.certified, ref.certified)
    assert got.certified is not None
    np.testing.assert_array_equal(got.at_upper, ref.at_upper)
    if case == "all-at-upper":
        assert got.status[0] == 0 and got.certified[0]
        np.testing.assert_allclose(got.x[0], [2.0, 3.0])
        assert got.z[0] == pytest.approx(2.3)
        assert got.at_upper[0, :2].all()
    if case == "fixed":
        ok = got.status == 0
        assert ok.any() and np.all(got.x[ok, 0] == 0.0)
    if case in ("infeasible", "unbounded"):
        assert got.status.tolist() == {"infeasible": [2, 0],
                                       "unbounded": [3, 0]}[case]
    if case == "unbounded":
        assert got.z[1] == pytest.approx(5.5)


def test_solve_arrays_with_bounds_float64_agrees_with_float32():
    args, maximize, ub = SOLVE_CASES["native"]
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU))
    r32 = solver.solve_arrays(*args, maximize=maximize, ub=ub)
    r64 = solver.solve_arrays(*args, maximize=maximize, ub=ub,
                              dtype=np.float64)
    np.testing.assert_array_equal(r64.status, r32.status)
    for i in np.flatnonzero(r32.status == 0):
        assert z_close(r32.z[i], r64.z[i])
    assert r64.certified.all()


def test_solve_lp_sweep_matches_jax():
    """tests/test_bounds.py::test_sweep_native_bounds_general on both
    packages: finite lower bounds, boxes, (-inf, u] and free variables,
    bucketed by shape; some buckets have finite upper bounds (K3), some
    none (K2)."""
    from simplex_tpu import LinearProgram as JLP
    from simplex_tpu.models.batched import solve_lp_sweep as j_sweep

    kws = [bounded_lp(s) for s in range(200, 216)]
    ref = j_sweep([JLP(**kw) for kw in kws])
    got = pt.solve_lp_sweep([pt.LinearProgram(**kw) for kw in kws],
                            pt.SolverConfig(device=CPU))
    assert len(got) == len(ref)
    for i, ((rx, rz, rs, rok), (gx, gz, gs, gok)) in enumerate(zip(ref, got)):
        assert (gs, gok) == (rs, rok), i
        if rok:
            assert z_close(rz, gz), (i, rz, gz)
            np.testing.assert_allclose(gx, rx, atol=1e-5)
            lp = kws[i]
            assert np.all(gx >= lp["lb"] - 1e-6)
            assert np.all(gx <= lp["ub"] + 1e-6)
        else:
            assert gx is None and gz is None
    assert sum(ok for _, _, _, ok in got) >= 4


@pytest.mark.gpu
def test_cuda_bounded_solve_agrees_with_the_cpu_path():
    """The bounded solve on the card (every step through K3) reaches the
    CPU path's verdicts, objectives and at-upper sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for args, maximize, ub in (SOLVE_CASES["30x50"], SOLVE_CASES["native"]):
        before = bk.LAUNCHES_K3
        gpu = pt.BatchedSimplexSolver(pt.SolverConfig()).solve_arrays(
            *args, maximize=maximize, ub=ub)
        launches = bk.LAUNCHES_K3 - before
        # The all-<= batch goes on in float64 after its loop (one K3 launch
        # a step of the finish's loop too); the mixed one does not.
        finish = profiling.recent("batched.solve_arrays")[-1]["counts"] \
            .get("finish_launches", 0)
        assert (finish > 0) == (ub is SOLVE_CASES["30x50"][2])
        cpu = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU)) \
            .solve_arrays(*args, maximize=maximize, ub=ub)
        np.testing.assert_array_equal(gpu.status, cpu.status)
        for i in np.flatnonzero(cpu.status == 0):
            assert z_close(cpu.z[i], gpu.z[i])
        # One K3 launch a step of the loop, none after its last.
        assert launches - finish == gpu.nit >= int(gpu.pivots.max()) > 0
