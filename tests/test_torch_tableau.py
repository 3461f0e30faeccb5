"""The port's tableau simplex (``simplex_tpu_torch/ops/tableau.py``) against
``simplex_tpu/ops/tableau.py`` on the same seeded inputs.

Step level: identical tableaus must give identical pivot choices and
flags.  Solve level: the same status, and the objective within rtol 1e-5
(float32; trajectories may split on near-ties).
"""
import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, CPU, seeded_lp

import jax.numpy as jnp
from simplex_tpu.core.problem import LinearProgram, compile_standard_form
from simplex_tpu.models.dense import _pad_plan
from simplex_tpu.ops import tableau as jt
from simplex_tpu_torch.ops import tableau as tt


def _random_tableau(seed, m=24, n=40):
    """A tableau whose pricing row has ties, zero and negative entries, and
    whose RHS has tolerance-negative and tied ratios."""
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(m + 1, n + 1)).astype(np.float32)
    T[:-1, -1] = np.abs(T[:-1, -1])
    T[3, -1] = -1e-7
    T[-1, 5] = T[-1, 9] = T[-1, :-1].min()       # tied best reduced cost
    T[-1, 11] = 0.0
    basis = rng.permutation(n)[:m].astype(np.int32)
    mask = rng.uniform(size=n) < 0.8
    weights = rng.uniform(0.5, 3.0, size=n).astype(np.float32)
    return T, basis, mask, weights


@pytest.mark.parametrize("rule", ["dantzig", "devex", "bland"])
@pytest.mark.parametrize("seed", range(4))
def test_select_pivot_identical(rule, seed):
    T, basis, mask, weights = _random_tableau(seed)
    use_bland = rule == "bland"
    w = weights if rule == "devex" else None
    a = jt.select_pivot(jnp.asarray(T), jnp.asarray(basis), jnp.asarray(mask),
                        1e-6, jnp.bool_(use_bland),
                        weights=None if w is None else jnp.asarray(w))
    b = tt.select_pivot(torch.from_numpy(T), torch.from_numpy(basis).long(),
                        torch.from_numpy(mask), 1e-6, torch.tensor(use_bland),
                        weights=None if w is None else torch.from_numpy(w))
    assert [int(v) for v in a] == [int(v) for v in b]


def test_select_pivot_ratio_tie_goes_to_the_first_row():
    T, basis, mask, _ = _random_tableau(7)
    mask[:] = True
    T[-1, :-1] = 1.0
    T[-1, 2] = -1.0                       # column 2 enters
    T[:-1, 2] = 1.0
    T[:-1, -1] = 5.0                      # every ratio ties
    a = jt.select_pivot(jnp.asarray(T), jnp.asarray(basis), jnp.asarray(mask),
                        1e-6, jnp.bool_(False))
    b = tt.select_pivot(torch.from_numpy(T), torch.from_numpy(basis).long(),
                        torch.from_numpy(mask), 1e-6, torch.tensor(False))
    assert [int(v) for v in a] == [int(v) for v in b] == [2, 0, 0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_devex_update_identical(seed):
    T, basis, mask, w = _random_tableau(seed)
    r, s = 4, 7
    a = jt._devex_update(jnp.asarray(w), jnp.asarray(T), jnp.asarray(basis),
                         jnp.int32(r), jnp.int32(s))
    b = tt._devex_update(torch.from_numpy(w), torch.from_numpy(T),
                         torch.from_numpy(basis).long(),
                         torch.tensor(r), torch.tensor(s))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def _sf(kw):
    lp = LinearProgram(**kw)
    row_pad, col_pad = _pad_plan(lp)
    return compile_standard_form(lp, row_pad=row_pad, col_pad=col_pad)


def test_refactor_tableau_matches_and_flags_a_singular_basis():
    sf = _sf(seeded_lp(3))
    st = tt.state_from_standard_form(sf, CPU, torch.float32)
    rows = st["T0"][:-1]
    T_new, ok = tt.refactor_tableau(rows, st["basis0"], st["obj_row_p2"])
    ref = jt.refactor_tableau(jnp.asarray(sf.tableau[:-1]),
                              jnp.asarray(sf.basis),
                              jnp.asarray(sf.obj_row_p2))
    assert bool(ok)
    np.testing.assert_allclose(T_new.numpy(), np.asarray(ref), atol=1e-5)
    singular = st["basis0"].clone()
    singular[1] = singular[0]
    _, ok = tt.refactor_tableau(rows, singular, st["obj_row_p2"])
    assert not bool(ok)


def _cases():
    cases = {f"anchor{i}": kw for i, kw in enumerate(ANCHORS)}
    cases.update({f"seed{s}": seeded_lp(s, 25, 25) for s in range(4)})
    cases["infeasible"] = dict(c=[1.0, 1.0], A=[[1.0, 1.0], [1.0, 1.0]],
                               b=[4.0, 6.0], ops=[-1, 1], maximize=True)
    cases["unbounded"] = dict(c=[1.0, 2.0], A=[[1.0, -1.0], [-1.0, 1.0]],
                              b=[2.0, 3.0], ops=[-1, -1], maximize=True)
    cases["degenerate"] = dict(c=[1.0, 1.0, 1.0],
                               A=[[1.0, 1.0, 0.0], [1.0, 0.0, 1.0],
                                  [0.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                               b=[1.0, 1.0, 1.0, 1.5], ops=[-1] * 4,
                               maximize=True)
    return cases


@pytest.mark.parametrize("devex", [True, False])
@pytest.mark.parametrize("name", list(_cases()))
def test_solve_tableau_same_status_and_objective(name, devex):
    sf = _sf(_cases()[name])
    kw = dict(need_phase1=sf.need_phase1, tol=1e-6, max_iters=2000,
              bland_after=256, refactor_every=8, devex=devex)
    Tj, bj, sj, ij = jt.solve_tableau(
        jnp.asarray(sf.tableau), jnp.asarray(sf.basis),
        jnp.asarray(sf.col_mask_p1), jnp.asarray(sf.col_mask_p2),
        jnp.asarray(sf.obj_row_p1), jnp.asarray(sf.obj_row_p2), **kw)
    st = tt.state_from_standard_form(sf, CPU, torch.float32)
    T0 = st["T0"].clone()
    Tp, bp, sp, ip = tt.solve_tableau(**st, **kw)
    assert torch.equal(st["T0"], T0)          # the anchor is left intact
    assert sp == int(sj)
    assert sp == {"infeasible": 2, "unbounded": 3}.get(name, 0)
    if sp == 0:
        np.testing.assert_allclose(float(-Tp[-1, -1]),
                                   float(-np.asarray(Tj)[-1, -1]), rtol=1e-5)
        x, z = tt.extract_solution(Tp, bp, sf.n_vars)
        xj, zj = jt.extract_solution(Tj, bj, sf.n_vars)
        np.testing.assert_allclose(float(z), float(zj), rtol=1e-5)
        assert x.shape == (sf.n_vars,)


@pytest.mark.parametrize("name", ["anchor0", "anchor1", "anchor2",
                                  "infeasible"])
def test_solve_tableau_history_matches_step_for_step(name):
    sf = compile_standard_form(LinearProgram(**_cases()[name]))
    kw = dict(need_phase1=sf.need_phase1, tol=1e-6, max_steps=8,
              bland_after=256, devex=True)
    a = jt.solve_tableau_history(
        jnp.asarray(sf.tableau), jnp.asarray(sf.basis),
        jnp.asarray(sf.col_mask_p1), jnp.asarray(sf.col_mask_p2),
        jnp.asarray(sf.obj_row_p2), **kw)
    st = tt.state_from_standard_form(sf, CPU, torch.float32)
    b = tt.solve_tableau_history(st["T0"], st["basis0"], st["col_mask_p1"],
                                 st["col_mask_p2"], st["obj_row_p2"], **kw)
    assert b[2] == int(a[2])
    np.testing.assert_array_equal(b[4].numpy(), np.asarray(a[4]))
    np.testing.assert_array_equal(b[5].numpy(), np.asarray(a[5]))
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    np.testing.assert_allclose(b[3].numpy(), np.asarray(a[3]), atol=1e-4,
                               rtol=1e-6)
