"""The port on the LP relaxations of Chu & Beasley's multidimensional
knapsack problems (``lpbench/traffic/mknap.py``, the ``mknapcb9.relax``
cell): ``max c.x, A x <= b, 0 <= x <= 1`` through
``BatchedSimplexSolver.solve_arrays(..., ub=)`` on the CPU (K3's twin).

* The port against the benchmark's plain bounded reference
  (``lpbench/reference/bounded.py``) on seeded draws, at m = 5, n = 40 for
  each tightness ratio and at the published m = 30, n = 500; the bounded
  reference itself against the one that turns each bound into a row
  (``lpbench/reference/simplex.py``).
* An escalated instance of a bounded batch gets ``at_upper`` from its
  ``x`` (the host certifiers leave the loop's), in ``solve_arrays`` and in
  ``solve_arrays_stream``.
* The loop's flip counter against the steps K3's twin takes.
* The float64 finish of float32 bounded solves, and the bounded refactor's
  exact basic columns.
"""
import os

import numpy as np
import pytest
import torch

import simplex_tpu_torch as pt
from lpbench.reference import bounded, simplex
from lpbench.traffic import mknap
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.ops import batched as tops
from simplex_tpu_torch.utils import profiling

CPU = pt.SolverConfig(device="cpu")
LAW = {"weights": [0, 1000], "tightness": [0.25, 0.5, 0.75],
       "profit_spread": 500.0, "ub": 1.0, "pool": 1, "dtype": "float32"}


def _draw(seed, B, m, n, **kw):
    return mknap.item(dict(LAW, batch=B, m=m, n=n, **kw), seed, 0)


def _solve(it, config=CPU):
    m = it["A"].shape[1]
    return pt.BatchedSimplexSolver(config).solve_arrays(
        it["c"], it["A"], it["b"], np.full(m, -1), maximize=True,
        ub=it["ub"])


def _check_against_reference(it, res):
    ref = bounded.solve(it["c"], it["A"], it["b"], it["ub"])
    np.testing.assert_array_equal(res.status, ref["status"])
    assert np.all(res.status == 0) and res.certified.all()
    z = ref["z"]
    assert np.all(np.abs(res.z - z) <= 1e-6 * (1 + np.abs(z)))
    A = it["A"].astype(np.float64)
    b = it["b"].astype(np.float64)
    u = it["ub"].astype(np.float64)
    x = res.x
    assert np.all(np.einsum("bmn,bn->bm", A, x) <= b + 1e-6 * (1 + b))
    assert np.all(x >= -1e-9) and np.all(x <= u + 1e-6)
    n = x.shape[1]
    at = res.at_upper[:, :n]
    assert np.all(np.abs(x[at] - u[at]) <= 1e-9 * (1 + u[at]))
    assert not res.at_upper[:, n:].any()
    return ref


@pytest.mark.parametrize("alpha", [0.25, 0.5, 0.75])
def test_small_draws_agree_with_the_bounded_reference(alpha):
    it = _draw(3000000017, 16, 5, 40, tightness=[alpha])
    assert np.all(it["alpha"] == alpha)
    res = _solve(it)
    _check_against_reference(it, res)
    # Bound flips are steps of the loop, and some are taken.
    assert np.all(res.flips <= res.pivots) and res.flips.sum() > 0


def test_the_published_width_agrees_with_the_bounded_reference():
    it = _draw(2**31 + 11, 2, 30, 500)
    res = _solve(it)
    _check_against_reference(it, res)
    # 32 x 640 float32: 81,920 B a tile, above K3's 64 KB stage, so on the
    # card every step of this solve streams.
    assert (32 * 640 * 4) > 64 * 1024
    rec = profiling.recent("batched.solve_arrays")[-1]
    assert rec["counts"]["bound_flips"] == int(res.flips.sum()) > 0
    assert "batched.finish" in {s[0] for s in rec["spans"]}


@pytest.mark.parametrize("case", ["mknap", "uniform", "unbounded"])
def test_the_bounded_reference_agrees_with_bounds_as_rows(case):
    rng = np.random.default_rng(7)
    if case == "mknap":
        it = _draw(11, 12, 4, 12)
        c, A, b, ub = it["c"], it["A"], it["b"], it["ub"]
    else:
        B, m, n = 12, 5, 9
        A = rng.uniform(0.05, 1.0, (B, m, n))
        b = rng.uniform(1.0, 5.0, (B, m))
        c = rng.uniform(0.1, 1.0, (B, n))
        ub = np.where(rng.random((B, n)) < 0.6, rng.uniform(0.2, 3, (B, n)),
                      np.inf)
        if case == "unbounded":
            # Variable 0 of every other LP is free of every row and of a
            # bound: the LP is unbounded.
            A[::2, :, 0] = 0.0
            ub[::2, 0] = np.inf
    got = bounded.solve(c, A, b, ub)
    ref = simplex.solve(c, A, b, ub)
    np.testing.assert_array_equal(got["status"], ref["status"])
    ok = ref["status"] == 0
    assert ok.any()
    if case == "unbounded":
        assert np.all(got["status"][::2] == 3)
    np.testing.assert_allclose(got["z"][ok], ref["z"][ok], rtol=1e-10)
    # The duals: dz/db of the rows and the reduced costs, as the row
    # reference gives them where the optimum is not degenerate.
    zy = np.einsum("bm,bm->b", np.asarray(b, np.float64)[ok], got["y"][ok])
    u = np.where(np.isfinite(ub), ub, 0.0)[ok]
    zr = np.einsum("bn,bn->b", np.maximum(got["rc"][ok], 0.0), u)
    np.testing.assert_allclose(zy + zr, got["z"][ok], rtol=1e-9)


def test_the_bounded_reference_solves_in_blocks_and_in_tf32():
    it = _draw(5, 10, 5, 30)
    one = bounded.solve(it["c"], it["A"], it["b"], it["ub"])
    blocks = bounded.solve(it["c"], it["A"], it["b"], it["ub"], block=3)
    for k in ("status", "x", "z"):
        np.testing.assert_array_equal(one[k], blocks[k])
    ctl = bounded.solve(it["c"], it["A"], it["b"], it["ub"],
                        precision="tf32")
    np.testing.assert_array_equal(ctl["status"], one["status"])
    gap = np.abs(ctl["z"] - one["z"]) / (1 + np.abs(one["z"]))
    assert 0 < gap.max() < 1e-2


def _escalating_batch():
    """A bounded batch whose loop stops after 12 steps: every instance
    claims the iteration limit, so the certifier escalates each one, with
    the loop's at-upper set left from mid-solve."""
    it = _draw(41, 6, 5, 40)
    return it, pt.SolverConfig(device="cpu", max_iters=12)


def test_an_escalated_instance_gets_at_upper_from_its_x():
    it, cfg = _escalating_batch()
    n = it["c"].shape[1]
    loop = _solve(it, pt.SolverConfig(device="cpu", max_iters=12,
                                      certify=False))
    assert np.all(loop.status == 1) and loop.at_upper[:, :n].any()
    res = _solve(it, cfg)
    assert res.escalated.all() and res.certified.all()
    assert profiling.recent("batched.solve_arrays")[-1]["counts"][
        "at_upper_reset"] == len(res.status)
    u = it["ub"].astype(np.float64)
    at = res.at_upper[:, :n]
    assert np.all(np.abs(res.x[at] - u[at]) <= 1e-9 * (1 + u[at]))
    assert np.array_equal(at, np.abs(res.x - u) <= 1e-12 * (1 + u))
    # The loop's own set would be stale: the check has something to catch.
    stale = loop.at_upper[:, :n]
    assert (stale & ~(np.abs(res.x - u) <= 1e-9 * (1 + u))).any()
    _check_against_reference(it, res)


def test_the_stream_resets_at_upper_as_solve_arrays_does():
    it, cfg = _escalating_batch()
    m = it["A"].shape[1]
    res = _solve(it, cfg)
    out = list(pt.solve_arrays_stream(
        iter([(it["c"], it["A"], it["b"], np.full(m, -1), it["ub"])]), cfg))
    assert len(out) == 1
    np.testing.assert_array_equal(out[0].at_upper, res.at_upper)
    np.testing.assert_array_equal(out[0].x, res.x)
    rec = profiling.recent("batched.certify")[-1]
    assert rec["counts"]["at_upper_reset"] == len(res.status)


def test_flips_count_the_twins_flip_steps(monkeypatch):
    """Each K3 step is told apart by what it wrote: a flip changes only the
    RHS column of the tableau, a pivot its entering column too."""
    it = _draw(9, 8, 5, 40)
    B = it["c"].shape[0]
    flips, piv = np.zeros(B, int), np.zeros(B, int)
    real = tops.fused_pivot_step_bounded_

    def step(T, *args, **kw):
        before = T.clone()
        out = real(T, *args, **kw)
        moving = out[10].numpy()
        same = torch.equal
        for i in np.flatnonzero(moving):
            if same(before[i, :, :-1], T[i, :, :-1]):
                flips[i] += 1
            else:
                piv[i] += 1
        return out

    monkeypatch.setattr(tops, "fused_pivot_step_bounded_", step)
    res = _solve(it, pt.SolverConfig(device="cpu", certify=False))
    assert flips.sum() > 0 and piv.sum() > 0
    np.testing.assert_array_equal(res.flips, flips)
    np.testing.assert_array_equal(res.pivots - res.flips, piv)
    rec = profiling.recent("batched.solve_arrays")[-1]
    assert rec["counts"]["bound_flips"] == int(flips.sum())


def test_a_batch_without_bounds_counts_no_flips():
    it = _draw(9, 4, 5, 40)
    res = pt.BatchedSimplexSolver(CPU).solve_arrays(
        it["c"], it["A"], it["b"], np.full(5, -1), maximize=True)
    assert res.flips is not None and not res.flips.any()
    assert res.pivots.sum() > 0


def _compiled(it, dtype):
    m = it["A"].shape[1]
    cb = tmb.compile_batch_uniform(it["c"], it["A"], it["b"], np.full(m, -1),
                                   True, ub=it["ub"])
    return tops.batch_state_from_compiled(cb, "cpu", dtype)


LOOP = dict(bland_after=1000, refactor_every=64, backend="auto",
            devex=True)


def test_the_finish_from_the_slack_basis_is_the_float64_solve():
    it = _draw(5, 4, 30, 500)
    st = _compiled(it, torch.float32)
    st64 = _compiled(it, torch.float64)
    T64, b64, au64, s64, _, p64 = tops.solve_tableau_batch_bounded(
        **st64, phase2_only=True, tol=1e-6, max_iters=20000, **LOOP)
    optimal = torch.zeros(4, dtype=torch.int32)
    x, z, status, basis, at_up, steps, launches = tops.finish_bounded_f64(
        st["T0"], st["T0"], st["basis0"], st["col_mask_p2"],
        st["obj_row_p2"], st["ub"], st["basis0"],
        torch.zeros_like(au64), optimal, 500, tol=1e-6, max_iters=20000,
        **LOOP)
    assert torch.equal(status, s64) and torch.equal(basis, b64)
    assert torch.equal(at_up, au64) and torch.equal(steps, p64)
    assert torch.equal(z, -T64[:, -1, -1]) and launches >= int(p64.max())


def test_the_finish_reaches_the_optimum_from_a_stopped_float32_loop():
    it = _draw(5, 3, 30, 500)
    st = _compiled(it, torch.float32)
    T, basis, at_up, status, _, _ = tops.solve_tableau_batch_bounded(
        **st, phase2_only=True, tol=1e-6, max_iters=150, **LOOP)
    assert torch.all(status == 1)
    # Instance 2 keeps its float32 answer: it did not stop optimal.
    claim = torch.tensor([0, 0, 1], dtype=torch.int32)
    x, z, st_f, b_f, au_f, steps, _ = tops.finish_bounded_f64(
        T, st["T0"], st["basis0"], st["col_mask_p2"], st["obj_row_p2"],
        st["ub"], basis, at_up, claim, 500, tol=1e-6, max_iters=20000,
        **LOOP)
    ref = bounded.solve(it["c"], it["A"], it["b"], it["ub"])
    assert st_f.tolist() == [0, 0, 1]
    zr = ref["z"][:2]
    assert np.all(np.abs(-z[:2].numpy() - zr) <= 1e-12 * np.abs(zr))
    assert torch.all(steps[:2] > 0) and steps[2] == 0
    assert torch.equal(b_f[2], basis[2]) and torch.equal(au_f[2], at_up[2])
    assert x.dtype == torch.float64


def test_a_warm_start_beyond_its_bounds_starts_over():
    """max 2 x1 + x2, x1 + x2 <= 3, 0 <= x <= 1, resumed from the basis
    {x1}: solved afresh, x1 = 3 lies beyond its bound, though the reduced
    costs there are optimal.  The finish starts the instance over from the
    slack basis and reaches x = (1, 1), not x1 = 3."""
    it = {"c": np.array([[2.0, 1.0]]), "A": np.array([[[1.0, 1.0]]]),
          "b": np.array([[3.0]]), "ub": np.ones((1, 2))}
    st = _compiled(it, torch.float64)
    basis = st["basis0"].clone()
    basis[0, 0] = 0
    none_up = torch.zeros_like(st["ub"], dtype=torch.bool)
    T_w, ok = tops._bounded_tableau(basis, none_up, st["ub"],
                                    st["T0"][:, :-1, :], st["obj_row_p2"])
    assert ok.all() and T_w[0, 0, -1] == 3.0
    assert not tops._within_bounds(T_w, basis, st["ub"],
                                   torch.tensor([4.0], dtype=torch.float64))
    x, z, status, b_f, au_f, steps, _ = tops.finish_bounded_f64(
        st["T0"], st["T0"], st["basis0"], st["col_mask_p2"],
        st["obj_row_p2"], st["ub"], basis, none_up,
        torch.zeros(1, dtype=torch.int32), 2, tol=1e-9, max_iters=1000,
        **LOOP)
    assert status.tolist() == [0] and float(-z[0]) == 3.0
    assert x[0].tolist() == [1.0, 1.0] and au_f[0, :2].tolist() == [True,
                                                                   True]
    assert int(steps[0]) == 2


def _slack_step_instance():
    """LP 14697 of item 1 of the cell's traffic on seed 2136361625 (16384
    LPs an item).  Solved by the bounded loop from the slack basis at a
    tolerance of 1e-6, its last pivot brings in a slack at a step of about
    450 while a row whose entry is below the tolerance sits out of the
    ratio test: that row's x_j, clipped to 1 on the tableau, is 1 + 2.3e-4
    solved afresh, within the certificate's tolerance."""
    d = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "mknapcb9_slack_step.npz"))
    return {"c": d["c"][None].astype(np.float32),
            "A": d["A"][None].astype(np.float32),
            "b": d["b"][None].astype(np.float32),
            "ub": np.ones((1, 500), np.float32)}


@pytest.mark.parametrize("tol, status", [(1e-6, 1), (1e-9, 0)])
def test_the_finish_trusts_no_answer_beyond_its_bounds(tol, status):
    """The float64 loop from the slack basis calls its answer optimal at
    both tolerances; at 1e-6 that answer, solved afresh, leaves a bound,
    and the finish (which from the slack basis takes the same steps)
    returns the iteration-limit status, which the certifier escalates; at
    1e-9 (``_FINISH_TOL``) the ratio test sees that row, and the answer is
    optimal and in bounds."""
    it = _slack_step_instance()
    st64 = _compiled(it, torch.float64)
    _, b64, au64, s64, _, _ = tops.solve_tableau_batch_bounded(
        **st64, phase2_only=True, tol=tol, max_iters=20000, **LOOP)
    assert s64.tolist() == [0]
    T_x, ok = tops._bounded_tableau(b64, au64, st64["ub"],
                                    st64["T0"][:, :-1, :],
                                    st64["obj_row_p2"])
    over = float(torch.where(b64[0] < 500, T_x[0, :-1, -1] - 1.0,
                             -1.0).max())
    assert ok.all() and (over > 1e-4) == bool(status)
    st = _compiled(it, torch.float32)
    none_up = torch.zeros_like(st["ub"], dtype=torch.bool)
    x, z, st_f, b_f, au_f, steps, _ = tops.finish_bounded_f64(
        st["T0"], st["T0"], st["basis0"], st["col_mask_p2"],
        st["obj_row_p2"], st["ub"], st["basis0"], none_up,
        torch.zeros(1, dtype=torch.int32), 500, tol=tol, max_iters=20000,
        **LOOP)
    assert st_f.tolist() == [status]
    if status:
        assert int(steps[0]) == 0 and torch.equal(b_f, st["basis0"])
    else:
        assert torch.equal(b_f, b64) and torch.equal(au_f, au64)
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_the_slack_step_instance_is_answered_within_its_bounds():
    """The whole path on that LP: the float32 loop's basis is infeasible in
    float64, the finish starts it over, and the certified answer keeps
    every x_j within [0, 1] without escalation."""
    it = _slack_step_instance()
    res = _solve(it)
    assert not res.escalated.any()
    _check_against_reference(it, res)
    assert float(res.x.max()) <= 1.0


def test_the_bounded_refactor_sets_the_basis_exactly():
    it = _draw(5, 3, 30, 500)
    st = _compiled(it, torch.float32)
    T, basis, at_up, _, _, _ = tops.solve_tableau_batch_bounded(
        **st, phase2_only=True, tol=1e-6, max_iters=150, **LOOP)
    T_new, ok = tops._bounded_tableau(basis, at_up, st["ub"],
                                      st["T0"][:, :-1, :], st["obj_row_p2"])
    assert ok.all()
    bl = basis.long()
    R = basis.shape[1]
    cols = T_new[:, :-1, :].gather(2, bl[:, None, :].expand(-1, R, -1))
    assert torch.equal(cols, torch.eye(R).expand_as(cols))
    assert torch.equal(T_new[:, -1, :].gather(1, bl), torch.zeros_like(
        bl, dtype=T_new.dtype))


@pytest.mark.gpu
def test_the_card_agrees_with_the_bounded_reference():
    """The published width on the card: every K3 step streams (a 32 x 640
    float32 tile), the float64 finish runs, and the answers hold to the
    reference as on the CPU.

        python -m pytest tests/test_torch_mknap.py -m gpu --noconftest
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from simplex_tpu_torch.ops import batched_kernel as bk

    it = _draw(2**31 + 23, 1024, 30, 500)
    before = bk.LAUNCHES_K3
    res = _solve(it, pt.SolverConfig())
    rec = profiling.recent("batched.solve_arrays")[-1]["counts"]
    assert bk.LAUNCHES_K3 - before == res.nit + rec["finish_launches"]
    assert rec["bound_flips"] == int(res.flips.sum()) > 0
    _check_against_reference(it, res)
