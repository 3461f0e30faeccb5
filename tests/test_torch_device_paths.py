"""The dual reoptimizer, PDHG and the two streams on the card against the CPU.

The ``gpu`` cases run the same seeded inputs on a CUDA device (K1 in the
dual loops, K2 and K3 in the batched stream, batched matvecs in PDHG) and
on the CPU (the kernels' twins), and need the same verdicts and objectives.
They import nothing of JAX, so on a machine with a card and no JAX they
run alone:

    python -m pytest tests/test_torch_device_paths.py -m gpu --noconftest

The other cases check, where no card is present, that each entry point
asked for "cuda" raises instead of running on the CPU.
"""
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MIXED_OPS, random_batch, random_ub, z_close

import simplex_tpu_torch as pt
from simplex_tpu_torch.models import pdhg
from simplex_tpu_torch.ops import batched_kernel, pivot_kernel
from simplex_tpu_torch.ops import tableau as tt


def _lp(seed, m=40, n=30, ub=False):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.2, 1.5, size=n)
    b = A @ x0 + rng.uniform(0.05, 0.4, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    kw = dict(c=c, A=A, ops=np.full(m, -1), maximize=True)
    if ub:
        kw["ub"] = np.where(rng.random(n) < 0.6,
                            x0 * rng.uniform(0.7, 1.6, n), np.inf)
    return kw, b, b * (1.0 - rng.uniform(0.01, 0.05, size=m))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return pt.SolverConfig(device="cuda")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.gpu
@pytest.mark.parametrize("bounded", [False, True])
def test_reoptimize_on_the_card_matches_the_cpu(cuda, bounded):
    cpu = pt.SolverConfig(device=CPU)
    for seed in range(3):
        kw, b, b2 = _lp(seed, ub=bounded)
        if bounded:
            parent = pt.RevisedSimplexSolver(cpu).solve(
                pt.LinearProgram(b=b, **kw))
        else:
            parent = pt.solve_lp(pt.LinearProgram(b=b, **kw), cpu)
        lp2 = pt.LinearProgram(b=b2, **kw)
        before = pivot_kernel.LAUNCHES
        got = pt.reoptimize(lp2, parent.basis, cuda,
                            at_upper=parent.at_upper)
        ref = pt.reoptimize(lp2, parent.basis, cpu, at_upper=parent.at_upper)
        assert got.status == ref.status == 0 and z_close(ref.z, got.z)
        assert pivot_kernel.LAUNCHES > before
        assert (got.at_upper is not None) == bounded


@pytest.mark.gpu
def test_dual_loops_on_the_card_match_the_cpu(cuda):
    """The classic loop from a dual-feasible start in float64: the same
    status, iterations and basis on both devices."""
    from simplex_tpu_torch.core.problem import compile_standard_form
    from simplex_tpu_torch.models.dense import _pad_plan

    kw, b, b2 = _lp(7)
    parent = pt.solve_lp(pt.LinearProgram(b=b, **kw),
                         pt.SolverConfig(device=CPU))
    lp2 = pt.LinearProgram(b=b2, **kw)
    row_pad, col_pad = _pad_plan(lp2)
    sf = compile_standard_form(lp2, row_pad=row_pad, col_pad=col_pad,
                               dtype=np.float64)
    rows = sf.tableau[:sf.m_pad]
    T_rows = np.linalg.solve(rows[:, parent.basis], rows)
    obj = sf.obj_row_p2 - sf.obj_row_p2[parent.basis] @ T_rows
    T = np.concatenate([T_rows, obj[None]])
    out = {}
    for dev in (CPU, "cuda"):
        out[dev] = tt.solve_tableau_dual(
            torch.as_tensor(T, device=dev),
            torch.as_tensor(parent.basis.astype(np.int64), device=dev),
            torch.as_tensor(sf.col_mask_p2, device=dev), tol=1e-9,
            refactor_every=4)
    assert out[CPU][2:] == out["cuda"][2:] and out[CPU][3] >= 1
    assert torch.equal(out[CPU][1], out["cuda"][1].cpu())
    torch.testing.assert_close(out["cuda"][0].cpu(), out[CPU][0],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.gpu
def test_batched_stream_on_the_card_matches_the_cpu(cuda):
    batches = []
    for k, kind in enumerate(("le", "ub", "mixed")):
        c, A, b, ops = random_batch(40 + k, B=256,
                                    ops=MIXED_OPS if kind == "mixed"
                                    else None)
        batches.append((c, A, b, ops) if kind != "ub" else
                       (c, A, b, ops, random_ub(k, (256, 13), 0.5, 2.0,
                                                frac=0.6)))
    batched_kernel.LAUNCHES = batched_kernel.LAUNCHES_K3 = 0
    got = list(pt.solve_arrays_stream(iter(batches), cuda))
    assert batched_kernel.LAUNCHES > 0 and batched_kernel.LAUNCHES_K3 > 0
    ref = list(pt.solve_arrays_stream(iter(batches),
                                      pt.SolverConfig(device=CPU)))
    for a, g in zip(ref, got):
        np.testing.assert_array_equal(a.status, g.status)
        assert g.certified.all()
        for za, zg in zip(a.z[a.success], g.z[g.success]):
            assert z_close(za, zg)


@pytest.mark.gpu
def test_pdhg_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(5)
    B, m, n = 64, 10, 6
    A = rng.uniform(0.1, 1.0, (B, m, n))
    b = rng.uniform(1.0, 5.0, (B, m))
    c = rng.uniform(0.1, 1.0, (B, n))
    kw = dict(tol=1e-5, max_iters=20000, dtype=np.float64)
    got = pt.PdhgSolver(device="cuda", **kw).solve_arrays(
        c, A, b, np.full(m, -1), maximize=True)
    ref = pt.PdhgSolver(device=CPU, **kw).solve_arrays(
        c, A, b, np.full(m, -1), maximize=True)
    np.testing.assert_array_equal(got.converged, ref.converged)
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-6,
                               atol=1e-6)
    out = list(pdhg.solve_arrays_stream(
        iter([(c, A, b, np.full(m, -1))]), tol=1e-9, max_iters=10,
        maximize=True, crossover="unconverged", device="cuda"))[0]
    assert np.all(out.converged) and len(out.exact) == B


def test_reoptimize_raises_without_a_gpu(no_cuda):
    kw, b, b2 = _lp(1, m=6, n=4)
    parent = pt.solve_lp(pt.LinearProgram(b=b, **kw),
                         pt.SolverConfig(device=CPU))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.reoptimize(pt.LinearProgram(b=b2, **kw), parent.basis)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DenseSimplexSolver().reoptimize(pt.LinearProgram(b=b2, **kw),
                                           parent.basis)


def test_pdhg_and_streams_raise_without_a_gpu(no_cuda):
    c, A, b, ops = random_batch(0, B=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PdhgSolver().solve_arrays(c, A, b, ops)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pdhg.solve_arrays_stream(iter([(c, A, b, ops)])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pt.solve_arrays_stream(iter([(c, A, b, ops)])))


def test_the_cpu_paths_run_where_asked(no_cuda):
    """The same entry points with device="cpu" run (the caller's choice,
    not a fallback)."""
    c, A, b, ops = random_batch(0, B=4)
    res = pt.PdhgSolver(device=CPU).solve_arrays(c, A, b, ops, maximize=True)
    assert res.x.shape == (4, 13) and np.all(np.isfinite(res.objective))
    out = list(pt.solve_arrays_stream(iter([(c, A, b, ops)]),
                                      pt.SolverConfig(device=CPU)))
    assert out[0].status.shape == (4,) and out[0].certified.all()
