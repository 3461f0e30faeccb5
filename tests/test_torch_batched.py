"""The batched classic path of the port against the JAX package.

* solve-loop level: ``ops/batched.py::solve_tableau_batch`` of both
  packages on the same ``CompiledBatch``, for the ``phase2_only`` loop and
  the general (two-phase) one, backend ``"xla"`` against the port's unfused
  step and ``"pallas_interpret"`` against K2's twin (``"pallas_interpret"``
  and ``"auto"``, which takes the twin on a CPU tensor).  Equal statuses;
  on ``phase2_only`` equal pivot counts and loop trip counts too; final
  tableaus within atol 1e-4, the tolerance the reference holds its own two
  backends to (tests/test_pallas_batched.py).  The general loop flips an
  instance to phase 2 at the end of a chunk, not in the iteration where it
  finished phase 1, so its trip count may differ;
* the helpers around the step (refactor, price-out, artificial eviction,
  the final polish, extraction) on the same mid-solve state;
* device assembly against ``compile_batch_uniform``;
* solve level: ``BatchedSimplexSolver.solve_arrays`` and
  ``solve_lp_batch`` of both packages with certification on: equal
  statuses, z within 1e-6·(1+|z|), equal certification flags.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (ANCHORS, CPU, MIXED_OPS, random_batch, seeded_lp,
                           z_close)

import simplex_tpu_torch as pt
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.ops import batched as tops
from simplex_tpu_torch.ops import batched_kernel as bk

# name -> (random_batch arguments, solve_tableau_batch keywords)
LOOP_CASES = {
    "le": (dict(seed=0), dict(phase2_only=True)),
    "le-devex": (dict(seed=0), dict(phase2_only=True, devex=True)),
    "le-bland": (dict(seed=2), dict(phase2_only=True, bland_after=0)),
    "le-refactor": (dict(seed=20, B=16, m=12, n=18),
                    dict(phase2_only=True, refactor_every=8)),
    "le-30x50": (dict(seed=4, B=16, m=30, n=50),
                 dict(phase2_only=True, devex=True)),
    "mixed": (dict(seed=1, ops=MIXED_OPS), {}),
    "mixed-devex": (dict(seed=5, ops=MIXED_OPS), dict(devex=True)),
    "mixed-bland": (dict(seed=6, ops=MIXED_OPS), dict(bland_after=0)),
    "mixed-refactor": (dict(seed=7, B=16, m=12, n=18,
                            ops=np.resize(MIXED_OPS, 12)),
                       dict(refactor_every=8)),
}
# The port's backend -> the reference's backend it is held to.
BACKENDS = {"xla": "xla", "pallas_interpret": "pallas_interpret",
            "auto": "pallas_interpret"}


@functools.lru_cache(maxsize=None)
def _compiled(case):
    from simplex_tpu.models.batched import compile_batch_uniform

    batch_kw, _ = LOOP_CASES[case]
    return compile_batch_uniform(*random_batch(**batch_kw), maximize=True)


@functools.lru_cache(maxsize=None)
def _jax_solve(case, backend):
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb = _compiled(case)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    out = jops.solve_tableau_batch(*args, backend=backend,
                                   **LOOP_CASES[case][1])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_solve_loop_matches_jax(case, backend):
    kw = LOOP_CASES[case][1]
    T, basis, status, iters, pivots = _jax_solve(case, BACKENDS[backend])
    st = tops.batch_state_from_compiled(_compiled(case), CPU, torch.float32)
    before = bk.LAUNCHES
    out = tops.solve_tableau_batch(**st, backend=backend, **kw)
    assert bk.LAUNCHES == before           # a CPU tensor never launches K2
    np.testing.assert_array_equal(out[2].numpy(), status)
    if kw.get("phase2_only"):
        np.testing.assert_array_equal(out[4].numpy(), pivots)
        assert out[3] == int(iters)
    np.testing.assert_allclose(out[0].numpy(), T, atol=1e-4)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32
    # The solve loop works on its own copy: T0 stays the refactor anchor.
    assert torch.equal(st["T0"], torch.from_numpy(_compiled(case).T0))


def test_solve_loop_rejects_an_unknown_backend():
    st = tops.batch_state_from_compiled(_compiled("le"), CPU, torch.float32)
    with pytest.raises(ValueError, match="backend"):
        tops.solve_tableau_batch(**st, backend="mosaic")


def test_max_iters_stops_the_loop_mid_chunk():
    """A cap below the first chunk's end is honoured exactly: every
    unfinished instance reports the iteration limit."""
    st = tops.batch_state_from_compiled(_compiled("le-30x50"), CPU,
                                        torch.float32)
    out = tops.solve_tableau_batch(**st, max_iters=3, phase2_only=True)
    assert out[3] == 3
    assert int(out[4].max()) <= 3
    assert set(out[2].tolist()) <= {0, 1}
    assert 1 in out[2].tolist()


def test_batch_state_accepts_either_packages_compiled_batch():
    from simplex_tpu.models.batched import compile_batch_uniform as j_compile

    args = random_batch(3, B=4, ops=MIXED_OPS)
    for cb in (j_compile(*args, maximize=True),
               tmb.compile_batch_uniform(*args, maximize=True)):
        for dt in (torch.float32, torch.float64):
            st = tops.batch_state_from_compiled(cb, CPU, dt)
            assert st["T0"].dtype == dt and st["obj_row_p2"].dtype == dt
            assert st["basis0"].dtype == torch.int32
            assert st["col_mask_p1"].dtype == torch.bool
            assert st["need_p1"].dtype == torch.bool
            assert st["T0"].is_contiguous()
            np.testing.assert_array_equal(st["T0"].numpy(),
                                          cb.T0.astype(st["T0"].numpy().dtype))
            np.testing.assert_array_equal(st["basis0"].numpy(), cb.basis)


# --------------------------------------------------------------------------
# Helpers on one mid-solve state


@functools.lru_cache(maxsize=None)
def _mid_state():
    """A mixed batch after a few unfused pivots (numpy), with its compiled
    batch."""
    cb = _compiled("mixed")
    st = tops.batch_state_from_compiled(cb, CPU, torch.float32)
    T, basis = st["T0"].clone(), st["basis0"].clone()
    B = T.shape[0]
    for _ in range(4):
        s, r, opt, unb = tops._select_pivot_b(
            T, basis, st["col_mask_p1"], 1e-6,
            torch.zeros(B, dtype=torch.bool))
        T, basis = tops._pivot_update_b(T, basis, r, s, ~opt & ~unb,
                                        clamp_rhs=True)
    return cb, T.numpy(), basis.numpy()


def test_refactor_matches_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis = _mid_state()
    active = np.arange(T.shape[0]) % 4 != 1
    ref = jops._refactor_b(jnp.asarray(T), jnp.asarray(basis),
                           jnp.asarray(cb.T0[:, :-1, :]),
                           jnp.asarray(cb.obj_row_p1), jnp.asarray(active))
    got = tops._refactor_b(torch.from_numpy(T), torch.from_numpy(basis),
                           torch.from_numpy(cb.T0[:, :-1, :]),
                           torch.from_numpy(cb.obj_row_p1),
                           torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(got.numpy()[~active], T[~active])


def test_refactor_keeps_the_tableau_of_a_singular_basis():
    cb, T, basis = _mid_state()
    bad = basis.copy()
    bad[0, 1] = bad[0, 0]                  # a repeated column: singular
    active = np.ones(T.shape[0], bool)
    got = tops._refactor_b(torch.from_numpy(T), torch.from_numpy(bad),
                           torch.from_numpy(cb.T0[:, :-1, :]),
                           torch.from_numpy(cb.obj_row_p1),
                           torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy()[0], T[0])
    assert np.all(np.isfinite(got.numpy()))


def test_price_out_and_eviction_match_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis = _mid_state()
    art = np.concatenate([cb.col_mask_p1 & ~cb.col_mask_p2,
                          np.zeros((T.shape[0], 1), bool)], 1)
    jT, jb = jops._evict_artificials_b(jnp.asarray(T), jnp.asarray(basis),
                                       jnp.asarray(art),
                                       jnp.asarray(cb.col_mask_p2), 1e-6)
    tT, tb = tops._evict_artificials_b(torch.from_numpy(T),
                                       torch.from_numpy(basis),
                                       torch.from_numpy(art),
                                       torch.from_numpy(cb.col_mask_p2),
                                       1e-6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    assert not np.array_equal(np.asarray(jb), basis)   # something evicted
    jP = jops._price_out_b(jT, jb, jnp.asarray(cb.obj_row_p2))
    tP = tops._price_out_b(tT, tb, torch.from_numpy(cb.obj_row_p2))
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), atol=1e-4)


def test_refine_and_extract_match_jax():
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    cb, T, basis = _mid_state()
    args = (T, basis, cb.basis, cb.T0[:, :-1, :], cb.obj_row_p1)
    jT = jops._refine_solution_b(*[jnp.asarray(a) for a in args])
    tT = tops._refine_solution_b(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
    jx, jz = jops.extract_solution_batch(jT, jnp.asarray(basis), cb.n_vars)
    tx, tz = tops.extract_solution_batch(tT, torch.from_numpy(basis),
                                         cb.n_vars)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)


# --------------------------------------------------------------------------
# Device assembly


def _assembly_cases():
    rng = np.random.default_rng(5)
    B, m, n = 6, 7, 5
    A = rng.normal(size=(B, m, n)).round(2)
    b = rng.uniform(-4, 8, size=(B, m)).round(2)   # negatives force flips
    c = rng.normal(size=(B, n)).round(2)
    maximize = rng.integers(0, 2, size=B).astype(bool)
    yield "mixed", (c, A, b, np.array([-1, 1, 0, -1, 1, 0, -1]), maximize), {}
    yield "le", (c, A, np.abs(b), np.full(m, -1), maximize), {}
    ops_b = np.where(rng.random((B, m)) < 0.5, -1, 1)
    yield "per-instance ops", (c, A, b, ops_b, True), {}
    ub = np.where(rng.random((B, n)) < 0.3, 0.0, 4.0)
    yield "ub masks", (c, A, b, np.full(m, -1), maximize), {"ub": ub}
    yield "f64 unaligned", (c, A, b, np.full(m, 1), maximize), {
        "dtype": np.float64, "align_total": False}


@pytest.mark.parametrize("name", [n for n, _, _ in _assembly_cases()])
def test_device_assembly_matches_host_compile(name):
    """``compile_batch_on_device`` builds what the JAX package's
    ``compile_batch_uniform`` (and the port's copy of it) builds."""
    from simplex_tpu.models.batched import compile_batch_uniform as j_compile

    _, args, kw = next(x for x in _assembly_cases() if x[0] == name)
    host = j_compile(*args, **kw)
    copy = tmb.compile_batch_uniform(*args, **kw)
    dev = tmb.compile_batch_on_device(*args, device=CPU, **kw)
    dt = {np.float32: torch.float32,
          np.float64: torch.float64}[kw.get("dtype", np.float32)]
    assert dev.T0.dtype == dt and dev.basis.dtype == torch.int32
    for f in ("T0", "obj_row_p1", "obj_row_p2"):
        np.testing.assert_array_equal(getattr(copy, f), getattr(host, f))
        np.testing.assert_allclose(getattr(dev, f).numpy(), getattr(host, f),
                                   atol=1e-6, err_msg=f)
    for f in ("basis", "col_mask_p1", "col_mask_p2", "need_p1"):
        np.testing.assert_array_equal(getattr(copy, f), getattr(host, f))
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      getattr(host, f), err_msg=f)
    assert dev.n_vars == host.n_vars
    np.testing.assert_array_equal(dev.maximize, host.maximize)
    if host.ub_ext is None:
        assert dev.ub_ext is None
    else:
        np.testing.assert_array_equal(dev.ub_ext, host.ub_ext)


# --------------------------------------------------------------------------
# Solve level


def _configs(**kw):
    from simplex_tpu.config import SolverConfig as JConfig

    return JConfig(**kw), pt.SolverConfig(device=CPU, **kw)


def _assert_same_results(ref, got):
    np.testing.assert_array_equal(got.status, ref.status)
    for i in np.flatnonzero(ref.status == 0):
        assert z_close(ref.z[i], got.z[i]), (i, ref.z[i], got.z[i])
    np.testing.assert_array_equal(got.certified, ref.certified)
    assert got.certified is not None and got.x.shape == ref.x.shape


def _infeasible_and_unbounded():
    # tests/test_batched_solver.py::test_batch_infeasible_and_unbounded_
    # detection: instance 0 infeasible (x <= 1 and x >= 3), 1 feasible.
    c = np.array([[1.0], [1.0]])
    A = np.tile(np.array([[1.0], [1.0]])[None], (2, 1, 1))
    b = np.array([[1.0, 3.0], [5.0, 2.0]])
    yield "infeasible", (c, A, b, np.array([-1, 1])), True
    # Instance 0 unbounded (x1 - x2 <= 1 with x1 + x2 maximized), 1 bounded.
    c = np.array([[1.0, 1.0], [1.0, 1.0]])
    A = np.array([[[1.0, -1.0], [-1.0, 1.0]], [[1.0, 1.0], [1.0, 0.0]]])
    b = np.array([[1.0, 2.0], [4.0, 3.0]])
    yield "unbounded", (c, A, b, np.array([-1, -1])), True
    # Per-instance objective sense with >= rows.
    c, A, b, _ = random_batch(31, B=8, m=5, n=4)
    yield "senses", (c, A, b, np.array([-1, 1, -1, 0, -1])), \
        np.arange(8) % 2 == 0


SOLVE_CASES = {
    "le": (random_batch(0), True),
    "mixed": (random_batch(1, ops=MIXED_OPS), True),
    "30x50": (random_batch(4, B=16, m=30, n=50), True),
    **{name: (args, mx) for name, args, mx in _infeasible_and_unbounded()},
}


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_arrays_matches_jax(case, backend):
    from simplex_tpu.models.batched import BatchedSimplexSolver as JSolver

    from simplex_tpu.config import SolverConfig as JConfig

    args, maximize = SOLVE_CASES[case]
    jcfg = JConfig(batched_backend=BACKENDS[backend])
    tcfg = pt.SolverConfig(device=CPU, batched_backend=backend)
    ref = JSolver(jcfg).solve_arrays(*args, maximize=maximize)
    got = pt.BatchedSimplexSolver(tcfg).solve_arrays(*args,
                                                    maximize=maximize)
    _assert_same_results(ref, got)
    if case == "infeasible":
        assert got.status.tolist() == [2, 0] and got.z[1] == pytest.approx(5)
    if case == "unbounded":
        assert got.status.tolist() == [3, 0]


def test_solve_arrays_dantzig_without_certification_matches_jax():
    from simplex_tpu.models.batched import BatchedSimplexSolver as JSolver

    jcfg, tcfg = _configs(pivot_rule="dantzig", certify=False)
    args = random_batch(8, B=10, m=12, n=9, ops=np.resize(MIXED_OPS, 12))
    ref = JSolver(jcfg).solve_arrays(*args, maximize=True)
    got = pt.BatchedSimplexSolver(tcfg).solve_arrays(*args, maximize=True)
    assert got.certified is None and ref.certified is None
    np.testing.assert_array_equal(got.status, ref.status)
    ok = ref.status == 0
    np.testing.assert_allclose(got.z[ok], ref.z[ok], rtol=1e-5)
    np.testing.assert_allclose(got.x[ok], ref.x[ok], atol=1e-4)


def test_solve_arrays_float64_agrees_with_float32():
    args = random_batch(9, B=8, ops=MIXED_OPS)
    cfg = pt.SolverConfig(device=CPU)
    r32 = pt.BatchedSimplexSolver(cfg).solve_arrays(*args, maximize=True)
    r64 = pt.BatchedSimplexSolver(cfg).solve_arrays(*args, maximize=True,
                                                    dtype=np.float64)
    np.testing.assert_array_equal(r64.status, r32.status)
    for i in np.flatnonzero(r32.status == 0):
        assert z_close(r32.z[i], r64.z[i])
    assert r64.certified.all()


def _lp_batches():
    yield "anchors", [dict(kw) for kw in ANCHORS]
    # Same variable count, different rows and operators; one with finite
    # bounds (lowered onto rows) and one with a free variable.
    lps = []
    for s in range(40):
        kw = seeded_lp(200 + s, max_m=12, max_n=8)
        if len(kw["c"]) == 5:
            lps.append(kw)
    lps = lps[:4]
    lps[1] = dict(lps[1], ub=np.full(5, 3.0))
    lps[2] = dict(lps[2], free=np.arange(5) == 0)
    yield "mixed", lps


@pytest.mark.parametrize("name", [n for n, _ in _lp_batches()])
def test_solve_lp_batch_matches_jax(name):
    from simplex_tpu import LinearProgram as JLP
    from simplex_tpu.models.batched import solve_lp_batch as j_solve

    kws = dict(_lp_batches())[name]
    jcfg, tcfg = _configs()
    ref = j_solve([JLP(**kw) for kw in kws], jcfg)
    got = pt.solve_lp_batch([pt.LinearProgram(**kw) for kw in kws], tcfg)
    _assert_same_results(ref, got)
    ok = ref.status == 0
    np.testing.assert_allclose(got.x[ok], ref.x[ok], atol=1e-5)
    if name == "anchors":
        np.testing.assert_allclose(got.z, [9833.333333, 153.333333, 10.0],
                                   rtol=1e-6)


def test_solve_is_deterministic():
    args = random_batch(42, B=8, m=5, n=4, ops=[-1, 1, 0, -1, -1])
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU))
    r1 = solver.solve_arrays(*args, maximize=True)
    r2 = solver.solve_arrays(*args, maximize=True)
    np.testing.assert_array_equal(r1.status, r2.status)
    np.testing.assert_array_equal(np.nan_to_num(r1.x), np.nan_to_num(r2.x))
    np.testing.assert_array_equal(r1.pivots, r2.pivots)


def test_bounded_batch_raises_naming_slice_3():
    """A finite ``ub`` no longer raises but solves on the bounded solver
    (tests/test_torch_bounded.py holds it to the reference), and
    all-infinite bounds are a classic batch, as in the reference."""
    c, A, b, ops = random_batch(10)
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU))
    res = solver.solve_arrays(c, A, b, ops, maximize=True,
                              ub=np.full(c.shape, 4.0))
    assert (res.status == 0).all() and res.certified.all()
    assert res.at_upper is not None and res.at_upper.shape == (12, 127)
    res = solver.solve_arrays(c, A, b, ops, maximize=True,
                              ub=np.full(c.shape, np.inf))
    assert (res.status == 0).all() and res.at_upper is None


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device="cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        solver.solve_arrays(*random_batch(0, B=2), maximize=True)


@pytest.mark.gpu
def test_cuda_solve_agrees_with_the_cpu_path():
    """The batched solve on the card (every step through K2) reaches the
    CPU path's verdicts and objectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for args in (random_batch(0, B=64, m=30, n=50),
                 random_batch(1, B=33, ops=MIXED_OPS)):
        before = bk.LAUNCHES
        gpu = pt.BatchedSimplexSolver(pt.SolverConfig()).solve_arrays(
            *args, maximize=True)
        launches = bk.LAUNCHES - before
        cpu = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU)) \
            .solve_arrays(*args, maximize=True)
        np.testing.assert_array_equal(gpu.status, cpu.status)
        for i in np.flatnonzero(cpu.status == 0):
            assert z_close(cpu.z[i], gpu.z[i])
        # One K2 launch a step of the loop, none after its last.
        assert launches == gpu.nit >= int(gpu.pivots.max()) > 0
