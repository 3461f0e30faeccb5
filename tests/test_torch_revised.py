"""The port's revised engine (``simplex_tpu_torch/models/revised.py``) against
the JAX engine: the same verdicts and objectives on netlib-style, bounded,
infeasible, unbounded and free-variable LPs and on a bounded warm start,
and, at the step level, one phase of the device loop equal to the jitted
reference from the same state in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, bounded_lp, z_close

import simplex_tpu.models.revised as j_rev
import simplex_tpu_torch.models.revised as t_rev
from simplex_tpu.config import SolverConfig as JConfig
from simplex_tpu.core.problem import LinearProgram as JLP
from simplex_tpu_torch.config import SolverConfig as TConfig
from simplex_tpu_torch.core.problem import LinearProgram as TLP
from simplex_tpu_torch.core.problem import compile_standard_form
from simplex_tpu_torch.utils.mps import generate_netlib_style


def _lp_kw(lp):
    return dict(c=lp.c, A=lp.A, b=lp.b, ops=lp.ops, maximize=lp.maximize,
                lb=lp.lb, ub=lp.ub)


def _solve_both(kw, **solve_kw):
    ref = j_rev.RevisedSimplexSolver(JConfig()).solve(JLP(**kw), **solve_kw)
    got = t_rev.RevisedSimplexSolver(TConfig(device=CPU)).solve(TLP(**kw),
                                                                **solve_kw)
    return ref, got


def _assert_same_verdict(ref, got):
    """The same status and certification flags; z within the gate."""
    assert (got.status, got.success, got.message) == \
        (ref.status, ref.success, ref.message)
    assert (got.x is None) == (ref.x is None)
    assert (got.duals is None) == (ref.duals is None)
    if ref.success:
        assert z_close(ref.z, got.z), (ref.z, got.z)
        np.testing.assert_allclose(got.x, ref.x, atol=1e-5)


@pytest.mark.parametrize("seed,m,n", [(0, 40, 120), (1, 120, 400)])
def test_netlib_style_matches_reference(seed, m, n):
    kw = _lp_kw(generate_netlib_style(seed, m=m, n=n))
    ref, got = _solve_both(kw)
    assert ref.status == 0
    _assert_same_verdict(ref, got)
    assert not got.escalated


@pytest.mark.parametrize("seed", range(1, 9))
def test_bounded_lps_match_reference(seed):
    """``tests/test_bounds.py::_random_bounded_lp``: boxes, free columns,
    (-inf, u] and negative lower bounds through the native bounded path."""
    ref, got = _solve_both(bounded_lp(seed))
    _assert_same_verdict(ref, got)


def test_infeasible_lp_matches_reference():
    kw = dict(c=[1.0, 1.0], A=[[1.0, 1.0], [1.0, 1.0]], b=[1.0, 3.0],
              ops=[-1, 1], maximize=True)
    ref, got = _solve_both(kw)
    assert ref.status == 2
    _assert_same_verdict(ref, got)


def test_unbounded_lp_matches_reference():
    kw = dict(c=[1.0, 1.0], A=[[-1.0, 1.0], [-1.0, 2.0]], b=[1.0, 4.0],
              ops=[-1, -1], maximize=True, ub=[np.inf, 50.0])
    ref, got = _solve_both(dict(kw, ub=[np.inf, np.inf]))
    assert ref.status == 3
    _assert_same_verdict(ref, got)
    # A box on x2 leaves x1 free to grow: still unbounded, now through
    # the bounded ratio test.
    ref, got = _solve_both(kw)
    assert ref.status == 3
    _assert_same_verdict(ref, got)


@pytest.mark.parametrize("seed", [3, 4])
def test_free_variables_match_reference(seed):
    kw = _lp_kw(generate_netlib_style(seed, m=20, n=48, n_free=6))
    ref, got = _solve_both(kw)
    assert ref.status == 0
    _assert_same_verdict(ref, got)


def test_bounded_warm_start_matches_reference():
    """``tests/test_bounds.py::test_bounded_warm_start_fewer_pivots``'s LP:
    a warm start from the cold solve's (basis, at_upper) on perturbed
    data gives the reference's verdict in fewer pivots."""
    rng = np.random.default_rng(300)
    m, n = 24, 16
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.2, 1.5, size=n)
    b = A @ x0 + rng.uniform(0.05, 0.4, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    ub = np.where(rng.random(n) < 0.6, x0 * rng.uniform(0.7, 1.6, n),
                  np.inf)
    kw = dict(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True, ub=ub)
    ref_cold, got_cold = _solve_both(kw)
    _assert_same_verdict(ref_cold, got_cold)
    assert got_cold.at_upper is not None and got_cold.at_upper.any()
    np.testing.assert_array_equal(got_cold.at_upper, ref_cold.at_upper)

    kw2 = dict(kw, b=b * 1.001)
    ref, got = _solve_both(kw2, warm_basis=got_cold.basis,
                           warm_at_upper=got_cold.at_upper)
    _assert_same_verdict(ref, got)
    assert got.nit < got_cold.nit and ref.nit < ref_cold.nit


def test_no_constraint_lp_falls_back_to_the_dense_engine():
    kw = dict(c=[1.0, 2.0], A=np.zeros((0, 2)), b=np.zeros(0),
              ops=np.zeros(0, int), maximize=False)
    ref, got = _solve_both(kw)
    _assert_same_verdict(ref, got)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lp = TLP(**_lp_kw(generate_netlib_style(0, m=10, n=30)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rev.RevisedSimplexSolver(TConfig()).solve(lp)


def _bounded_netlib(seed):
    """A 40x120 netlib-style LP with upper bounds on half the columns and
    mixed cost signs, so phase 2 flips bounds and enters from them."""
    lp = generate_netlib_style(seed, m=40, n=120)
    rng = np.random.default_rng(seed + 100)
    ub = np.where(rng.random(120) < 0.5, rng.uniform(0.5, 3.0, 120), np.inf)
    c = lp.c * np.where(rng.random(120) < 0.3, -1, 1)
    return TLP(c=c, A=lp.A, b=lp.b, ops=lp.ops, maximize=False, ub=ub)


def _close(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - got).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("seed,devex", [(2, True), (4, True), (0, False)])
def test_phase_equals_the_jitted_reference_in_float64(seed, devex):
    """Phase 1 to its end, then 150 iterations of phase 2 (two refactors,
    at iterations 63 and 127), from the same state: equal basis, at_upper,
    iters and status; B_inv, x_B and the objective within 1e-12 of the
    largest entry."""
    sf = compile_standard_form(_bounded_netlib(seed), dtype=np.float64,
                               bounded=True)
    m, n = sf.m_pad, sf.n_pad
    A, b = sf.tableau[:m, :n], sf.tableau[:m, n]
    ub = sf.ub_ext
    art = np.concatenate([sf.col_mask_p1 & ~sf.col_mask_p2,
                          np.ones(m, bool)])[:n]
    flips = 0
    with jax.enable_x64(True):
        J = jnp.asarray

        def T(a):
            return torch.as_tensor(np.array(a))

        at0 = np.zeros(n, bool)
        B_inv, x_B = j_rev._refactor(J(A), J(b), J(sf.basis), J(at0), J(ub))
        state = (B_inv, x_B, J(sf.basis), J(at0))
        for phase2, cost, cm, max_iters in (
                (False, sf.obj_row_p1, sf.col_mask_p1, 10_000),
                (True, sf.obj_row_p2, sf.col_mask_p2, 150)):
            args = (cost[:n + 1], cm, art)
            ref = j_rev._run_phase_revised(
                J(A), J(b), *map(J, args), *state, J(ub), jnp.int32(0),
                jnp.bool_(phase2), tol=1e-9, max_iters=max_iters,
                bland_after=60, devex=devex)
            got = t_rev._run_phase_revised(
                T(A), T(b), *map(T, args), T(state[0]), T(state[1]),
                T(np.asarray(state[2], np.int64)), T(state[3]), T(ub), 0,
                phase2, tol=1e-9, max_iters=max_iters, bland_after=60,
                devex=devex)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
            assert (got[4], got[5]) == (int(ref[4]), int(ref[5]))
            assert _close(ref[0], got[0].numpy())
            assert _close(ref[1], got[1].numpy())
            assert abs(float(ref[6]) - got[6]) <= 1e-12 * (
                1.0 + abs(float(ref[6])))
            assert got[0].dtype == torch.float64
            flips += int(np.asarray(ref[3]).sum())
            state = ref[:4]
    assert got[4] >= 64         # the phase 2 run spans a refactor
    assert flips > 0            # and ends with columns at their upper bound
