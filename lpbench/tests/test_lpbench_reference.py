"""The plain reference and the comparison that decides ``correct``."""
import numpy as np
import pytest

from lpbench.reference import compare, simplex
from lpbench.tests._tiny import rng_lps


def test_hand_solved_anchor():
    # max 15 x1 + 18 x2  s.t.  4x1+2x2 <= 2000, 2x1+6x2 <= 2400,
    # 20x1+28x2 <= 14000: x = (388.89, 222.22), z = 9833.3333.
    r = simplex.solve([[15, 18]], [[[4, 2], [2, 6], [20, 28]]],
                      [[2000, 2400, 14000]])
    assert r["status"][0] == 0
    assert r["z"][0] == pytest.approx(9833.333333333, abs=1e-6)
    np.testing.assert_allclose(r["x"][0], [3500 / 9, 2000 / 9], rtol=1e-12)
    # Shadow prices: rows 1 and 3 tight; row 2 slack.
    np.testing.assert_allclose(r["y"][0], [5 / 6, 0.0, 7 / 12], atol=1e-12)


def test_unbounded_and_iteration_limit():
    r = simplex.solve([[1.0, 1.0]], [[[1.0, -1.0]]], [[1.0]])
    assert r["status"][0] == simplex.UNBOUNDED and np.isnan(r["z"][0])
    c, A, b, _ = rng_lps(1, 4, 30, 50)
    assert (simplex.solve(c, A, b, max_iters=2)["status"]
            == simplex.ITERATION_LIMIT).all()


@pytest.mark.parametrize("bounded", [False, True])
def test_agrees_with_highs(bounded):
    linprog = pytest.importorskip("scipy.optimize").linprog
    c, A, b, ub = rng_lps(7, 24, 30, 50, bounded)
    r = simplex.solve(c, A, b, ub)
    assert (r["status"] == 0).all()
    for k in range(len(c)):
        bounds = [(0, None if ub is None or not np.isfinite(ub[k, j])
                   else ub[k, j]) for j in range(c.shape[1])]
        h = linprog(-c[k], A_ub=A[k], b_ub=b[k], bounds=bounds,
                    method="highs")
        assert r["z"][k] == pytest.approx(-h.fun, rel=1e-12)
        np.testing.assert_allclose(r["x"][k], h.x, atol=1e-9)
        np.testing.assert_allclose(r["y"][k], -h.ineqlin.marginals,
                                   atol=1e-9)


def _answers(r):
    return {k: r[k] for k in ("status", "x", "z", "y", "rc")}


def test_the_reference_passes_and_the_control_fails_its_own_check():
    c, A, b, _ = rng_lps(3, 64, 30, 50)
    lp = {"c": c, "A": A, "b": b, "ub": None}
    ref = simplex.solve(c, A, b)
    same = compare.primal_readings(lp, ref, _answers(ref))
    assert same["status_mismatch"] == 0
    assert max(same["z_gap"], same["x_viol"], same["dual_viol"],
               same["rc_gap"]) < 1e-12
    ctl = compare.primal_readings(
        lp, ref, _answers(simplex.solve(c, A, b, precision="tf32")))
    limits = {"z_gap": 1e-4, "x_obj_gap": 1e-4, "x_viol": 1e-4}
    assert compare.judge(same, limits)[0]
    assert not compare.judge(ctl, limits)[0]
    assert min(ctl[k] for k in limits) > 1e-4


def test_a_tie_is_not_an_error_but_an_infeasible_x_is():
    # max x1 + x2 s.t. x1 + x2 <= 1: every point of the edge is optimal.
    lp = {"c": np.array([[1.0, 1.0]]), "A": np.array([[[1.0, 1.0]]]),
          "b": np.array([[1.0]]), "ub": None}
    ref = simplex.solve(lp["c"], lp["A"], lp["b"])
    other = {"status": np.array([0]), "x": np.array([[0.25, 0.75]]),
             "z": np.array([1.0])}
    r = compare.primal_readings(lp, ref, other)
    assert r["x_obj_gap"] == 0 and r["x_viol"] == 0
    bad = dict(other, x=np.array([[0.5, 0.75]]))
    assert compare.primal_readings(lp, ref, bad)["x_viol"] > 0.1


def test_judge_fails_a_missing_or_nan_number():
    ok, checks = compare.judge({"z_gap": float("nan")},
                               {"z_gap": 1.0, "x_viol": 1.0})
    assert not ok and checks["x_viol"]["value"] is None


def test_merge_adds_counts_and_keeps_the_worst_gap():
    m = compare.merge([{"status_mismatch": 1, "z_gap": 1e-9,
                        "escalated_share": 0.5, "_n": 2},
                       {"status_mismatch": 2, "z_gap": 1e-7,
                        "escalated_share": 0.0, "_n": 6}])
    assert m == {"status_mismatch": 3, "z_gap": 1e-7,
                 "escalated_share": 0.125}
