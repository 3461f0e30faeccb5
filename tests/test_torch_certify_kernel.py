"""The float64 certifier of all-``<=`` batches on the card without bounds
(``ops/certify_kernel.py``, ``csrc/certify_bounded.cu`` with one ``+inf``
bound row) and its route (``models/batched.py::_certify_on_device``).

On the CPU: the twin ``certify_le_ref`` against the host copy
``models/certify.py::certify_sweep_le_f64`` on solved batches, with failures
planted in some instances (an all-slack basis that is dual infeasible, a
negative ``x_B``, a basis index past ``n + m``, a duplicated structural
column, claimed UNBOUNDED and ITERATION_LIMIT statuses): the same verdicts
(the host copy's pre-escalation ones, ``~escalated``), and ``x``, ``fun``
and ``z`` within 1e-12 of the instance's scale.  ``_certify_on_device`` on
CPU tensors against ``certify_uniform_result`` on the whole batch: equal
statuses, certification and escalation flags, and the same number of
escalations.

On a card (``gpu``; this file imports no JAX, so ``--noconftest`` runs it
there): the kernel against the twin, ``solve_arrays`` launching it once a
call and reaching the CPU path's verdicts, and the batches it must not take
leaving its launch count alone.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import CPU

import simplex_tpu_torch as pt
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.models import certify as tcert
from simplex_tpu_torch.ops import certify_kernel as ck

# name -> (seed, B, m, n, dtype of the inputs)
CASES = {
    "m1": (1, 64, 1, 3, np.float32),
    "m5-n-below-m": (2, 256, 5, 3, np.float32),
    "m5": (3, 256, 5, 9, np.float32),
    "m30-n-below-m": (4, 128, 30, 20, np.float32),
    "m30x50": (5, 256, 30, 50, np.float32),
    "m32": (6, 128, 32, 40, np.float32),
    "m64-n-below-m": (7, 48, 64, 40, np.float32),
    "m64": (8, 48, 64, 80, np.float32),
    "m30x50-f64-inputs": (9, 128, 30, 50, np.float64),
}


def _lps(seed, B, m, n, dtype):
    """A batch of bounded all-``<=`` LPs with ``b > 0``; costs of both
    signs and senses mixed, so the optimal bases hold structural and
    slack columns."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (B, m, n))
    b = rng.uniform(1.0, 5.0, (B, m))
    c = rng.uniform(-1.0, 1.0, (B, n))
    maxi = rng.random(B) < 0.5
    # Instance 0 maximizes positive costs: its all-slack basis is primal
    # feasible and dual infeasible.
    c[0], maxi[0] = np.abs(c[0]) + 0.1, True
    return c.astype(dtype), A.astype(dtype), b.astype(dtype), maxi


def _plant(res, c, A, b, maxi):
    """Plant one failure of each kind (data and claims changed in place):
    returns the changed ``b`` and the planted instances."""
    B, m, n = A.shape
    basis, status = res.basis, res.status
    planted = [0, 2, 4, 5]
    basis[0, :m] = n + np.arange(m)                    # all slack
    status[0] = 0
    basis[2, 0] = n + m                                # past the end
    status[2] = 0
    status[4] = 3                                      # unbounded claim
    status[5] = 1                                      # iteration limit
    if n >= 2 and m >= 2:                              # duplicate column
        basis[3, 0] = basis[3, 1] = 0
        planted.append(3)
    # A negative x_B: b made from an optimal basis with a structural column
    # at a point where one basic level is below zero (a slack's where there
    # is one); b stays >= 0, as A >= 0.05.
    b = b.copy()
    for i in range(6, B if m >= 2 else 6):
        bidx = basis[i, :m]
        struct = bidx < n
        if status[i] != 0 or not struct.any():
            continue
        Bm = np.where(struct[None, :],
                      A[i][:, np.where(struct, bidx, 0)].astype(np.float64),
                      np.arange(m)[:, None] == bidx[None, :] - n)
        xb = np.ones(m)
        xb[np.flatnonzero(~struct)[0] if (~struct).any()
           else np.flatnonzero(struct)[0]] = -0.01
        b[i] = (Bm @ xb).astype(b.dtype)
        assert (b[i] >= 0).all()
        planted.append(i)
        break
    return b, sorted(planted)


@functools.lru_cache(maxsize=None)
def _solved(case):
    """The case's LPs, their CPU solve (uncertified) with planted claims."""
    seed, B, m, n, dtype = CASES[case]
    c, A, b, maxi = _lps(seed, B, m, n, dtype)
    res = pt.BatchedSimplexSolver(pt.SolverConfig(
        device=CPU, certify=False)).solve_arrays(
            c, A, b, np.full(m, -1), maximize=maxi)
    res.basis = np.array(res.basis)
    res.status = np.array(res.status)
    b, planted = _plant(res, c, A, b, maxi)
    return c, A, b, maxi, res, planted


def _fresh(case):
    c, A, b, maxi, res, planted = _solved(case)
    res = dataclasses.replace(res, basis=res.basis.copy(),
                              status=res.status.copy(), x=res.x.copy(),
                              z=res.z.copy(), fun=res.fun.copy())
    return c, A, b, maxi, res, planted


def _tensors(c, A, b, maxi, res, device):
    """The certifier's arguments: the tensors on ``device``, then the
    tolerance the solve passes (the host copy's)."""
    t = functools.partial(torch.as_tensor, device=device)
    return (t(A), t(b), t(c), t(maxi), t(res.basis.astype(np.int32)),
            t(res.status.astype(np.int32)), tmb._CERT_TOL)


def _close(got, want, scale):
    """Equal NaN patterns, and within 1e-12 of ``1 + scale``."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    tol = 1e-12 * (1.0 + np.broadcast_to(scale, want.shape))
    assert np.all(np.abs(got[fin] - want[fin]) <= tol[fin])


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_agrees_with_the_host_certifier(case):
    c, A, b, maxi, res, planted = _fresh(case)
    ok, x, fun = ck.certify_le_ref(*_tensors(c, A, b, maxi, res, CPU))
    ok, x, fun = ok.numpy(), x.numpy(), fun.numpy()
    host = tcert.certify_sweep_le_f64(res.status, res.basis, c, A, b, maxi)
    np.testing.assert_array_equal(ok, ~host["escalated"])
    # Every planted claim fails, and nothing else.
    assert len(planted) == (6 if A.shape[1] >= 2 else 4)
    np.testing.assert_array_equal(np.flatnonzero(~ok), planted)
    xs = np.abs(np.where(ok[:, None], x, 0.0)).max(1)
    _close(x[ok], host["x"][ok], xs[ok][:, None])
    _close(fun[ok], host["fun"][ok], np.abs(fun[ok]))
    z = np.where(maxi, -fun, fun) + 0.0
    _close(z[ok], host["z"][ok], np.abs(z[ok]))
    assert np.isnan(x[~ok]).all() and np.isnan(fun[~ok]).all()


@pytest.mark.parametrize("case", ["m1", "m5-n-below-m", "m30x50-f64-inputs",
                                  "m64"])
def test_no_bounds_is_one_inf_row(case):
    """Without ``ub`` the twin and the wrapper give, bit for bit, what they
    give with an explicit ``(n,)`` ``+inf`` row and no ``at_upper``."""
    c, A, b, maxi, res, _ = _fresh(case)
    args = _tensors(c, A, b, maxi, res, CPU)
    inf = torch.full((A.shape[2],), torch.inf, dtype=args[0].dtype)
    for fn in (ck.certify_le_ref, ck.certify_le_):
        for got, want in zip(fn(*args), fn(*args, inf, None)):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)


def test_twin_rejects_a_singular_basis_of_slacks():
    """Two basic columns of one slack: an exact zero pivot."""
    c, A, b, maxi, res, _ = _fresh("m5")
    n = A.shape[2]
    res.basis[7, :2] = n
    ok, x, _ = ck.certify_le_ref(*_tensors(c, A, b, maxi, res, CPU))
    assert not ok[7] and np.isnan(x[7].numpy()).all()


@pytest.mark.parametrize("case", ["m5", "m30x50", "m30x50-f64-inputs"])
def test_certify_on_device_matches_the_host_path(case):
    """``_certify_on_device`` on CPU tensors (the twin does the kernel's
    part), its sub-batch through the host copy, against
    ``certify_uniform_result`` on the whole batch.  The inputs go up in the
    solve's float32; float64 inputs are uploaded again for the check."""
    c, A, b, maxi, res, _ = _fresh(case)
    m = A.shape[1]
    ops = np.full(m, -1)
    tensors, maxi_np, _ = tmb._upload(c, A, b, ops, maxi, np.float32, CPU)
    assert tensors[1].dtype == torch.float32
    host_res = dataclasses.replace(res, status=res.status.copy(),
                                   x=res.x.copy(), z=res.z.copy(),
                                   fun=res.fun.copy())
    before = tcert.ESCALATIONS
    want = tmb.certify_uniform_result(host_res, c, A, b, ops, maxi)
    host_escalations = tcert.ESCALATIONS - before
    before = tcert.ESCALATIONS
    got = tmb._certify_on_device(res, c, A, b, ops, maxi_np, tensors)
    assert tcert.ESCALATIONS - before == host_escalations > 0
    for name in ("status", "certified", "escalated", "success"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    scale = np.abs(np.nan_to_num(want.x)).max(1, keepdims=True)
    _close(got.x, want.x, scale)
    _close(got.z, want.z, np.abs(np.nan_to_num(want.z)))


def test_certify_on_device_counts_its_fallback():
    c, A, b, maxi, res, planted = _fresh("m5")
    ops = np.full(A.shape[1], -1)
    tensors, maxi_np, _ = tmb._upload(c, A, b, ops, maxi, np.float32, CPU)
    from simplex_tpu_torch.utils import profiling

    with profiling.solve_record("test.fallback") as rec:
        got = tmb._certify_on_device(res, c, A, b, ops, maxi_np, tensors)
    assert rec["counts"]["certify_fallback"] == len(planted)
    assert [s[0] for s in rec["spans"]].count("certify.device") == 1
    np.testing.assert_array_equal(np.flatnonzero(got.escalated), planted)


def test_the_route_takes_only_cuda_le_batches_without_bounds():
    A = torch.zeros((2, 3, 4))
    b = np.ones((2, 3))
    ops = np.full(3, -1)
    assert not tmb._certifies_on_device(A, b, ops, None)      # CPU tensors
    cuda = type("FakeCuda", (), {"type": "cuda"})()

    class T:
        device = cuda

        def __init__(self, shape):
            self.shape = shape

    ok = T((2, 3, 4))
    assert tmb._certifies_on_device(ok, b, ops, None)
    assert not tmb._certifies_on_device(ok, b, np.array([-1, 1, -1]), None)
    assert not tmb._certifies_on_device(ok, -b, ops, None)
    # Bounds in [0, +inf] go to the same kernel
    # (tests/test_torch_certify_bounded.py); a negative one goes nowhere.
    assert not tmb._certifies_on_device(ok, b, ops, -np.ones(4))
    assert not tmb._certifies_on_device(T((2, ck.MAX_ROWS + 1, 4)),
                                        np.ones((2, ck.MAX_ROWS + 1)),
                                        np.full(ck.MAX_ROWS + 1, -1), None)
    assert tmb._certifies_on_device(T((2, ck.MAX_ROWS, 4)),
                                    np.ones((2, ck.MAX_ROWS)),
                                    np.full(ck.MAX_ROWS, -1), None)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    c, A, b, maxi, res, _ = _fresh("m5")
    args = list(_tensors(c, A, b, maxi, res, CPU))
    with pytest.raises(TypeError):
        ck.certify_le_(*args[:4], args[4].long(), *args[5:])
    with pytest.raises(ValueError):
        ck.certify_le_(args[0][:, :, :0], *args[1:])
    with pytest.raises(ValueError):
        ck.certify_le_(args[0].transpose(1, 2).contiguous()
                       .transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        ck.certify_le_(torch.zeros((2, ck.MAX_ROWS + 1, 3)),
                       torch.zeros((2, ck.MAX_ROWS + 1)), torch.zeros((2, 3)),
                       torch.zeros(2, dtype=torch.bool),
                       torch.zeros((2, ck.MAX_ROWS + 1), dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), tmb._CERT_TOL)


# ---------------------------------------------------------------- card --- #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _cuda_solved(seed, B, m, n):
    c, A, b, maxi = _lps(seed, B, m, n, np.float32)
    res = pt.BatchedSimplexSolver(pt.SolverConfig(certify=False)) \
        .solve_arrays(c, A, b, np.full(m, -1), maximize=maxi)
    res.basis = np.array(res.basis)
    res.status = np.array(res.status)
    b, planted = _plant(res, c, A, b, maxi)
    return c, A, b, maxi, res, planted


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16384, 30, 50), (64, 1, 3), (256, 5, 3),
                                   (256, 5, 9), (128, 30, 20),
                                   (128, 32, 40), (48, 64, 40),
                                   (48, 64, 80), (64, 30, 1000)])
def test_kernel_matches_the_twin(shape):
    _card()
    B, m, n = shape
    c, A, b, maxi, res, planted = _cuda_solved(11, B, m, n)
    for dt in (np.float32, np.float64):
        args = (c.astype(dt), A.astype(dt), b, maxi, res)
        before = ck.LAUNCHES_CERT
        ok, x, fun = ck.certify_le_(*_tensors(*args, "cuda"))
        torch.cuda.synchronize()
        assert ck.LAUNCHES_CERT == before + 1
        rok, rx, rfun = ck.certify_le_ref(*_tensors(*args, CPU))
        np.testing.assert_array_equal(ok.cpu().numpy(), rok.numpy())
        assert not rok[planted].any() and rok.sum() >= B - len(planted) - 8
        xs = np.abs(np.nan_to_num(rx.numpy())).max(1, keepdims=True)
        _close(x.cpu().numpy(), rx.numpy(), xs)
        _close(fun.cpu().numpy(), rfun.numpy(), np.abs(rfun.numpy()))


@pytest.mark.gpu
def test_solve_arrays_certifies_on_the_card():
    _card()
    for seed, B, m, n, dt in ((12, 2048, 30, 50, np.float32),
                              (13, 512, 30, 50, np.float64),
                              (14, 256, 64, 80, np.float32)):
        c, A, b, maxi = _lps(seed, B, m, n, dt)
        ops = np.full(m, -1)
        before = ck.LAUNCHES_CERT
        gpu = pt.BatchedSimplexSolver(pt.SolverConfig()).solve_arrays(
            c, A, b, ops, maximize=maxi)
        assert ck.LAUNCHES_CERT == before + 1
        cpu = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU)) \
            .solve_arrays(c, A, b, ops, maximize=maxi)
        np.testing.assert_array_equal(gpu.status, cpu.status)
        np.testing.assert_array_equal(gpu.certified, cpu.certified)
        assert gpu.certified.all()
        ok = cpu.status == 0
        assert np.all(np.abs(gpu.z[ok] - cpu.z[ok])
                      <= 1e-6 * (1 + np.abs(cpu.z[ok])))


@pytest.mark.gpu
def test_batches_the_kernel_does_not_take_stay_on_the_host():
    _card()
    solver = pt.BatchedSimplexSolver(pt.SolverConfig())
    c, A, b, maxi = _lps(15, 64, 9, 13, np.float32)
    ops = np.full(9, -1)
    ge = ops.copy()
    ge[3] = 1
    neg = b.copy()
    neg[5, 2] = -0.5
    for kw in (dict(ops=ge), dict(b=neg)):
        args = dict(c=c, A=A, b=b, ops=ops, maximize=maxi)
        args.update(kw)
        before = ck.LAUNCHES_CERT
        res = solver.solve_arrays(**args)
        assert ck.LAUNCHES_CERT == before
        assert res.certified is not None
    m = ck.MAX_ROWS + 1
    c, A, b, maxi = _lps(16, 16, m, 70, np.float32)
    before = ck.LAUNCHES_CERT
    solver.solve_arrays(c, A, b, np.full(m, -1), maximize=maxi)
    assert ck.LAUNCHES_CERT == before
