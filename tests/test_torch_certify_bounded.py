"""The float64 certifier of all-``<=`` batches on the card with bounds
(``ops/certify_kernel.py::certify_le_`` with ``ub``,
``csrc/certify_bounded.cu``) and its route
(``models/batched.py::_certify_on_device`` with ``ub``).

On the CPU: the twin ``certify_le_ref`` with ``ub`` against the host copy
``models/certify.py::certify_sweep_le_f64(ub=, at_upper=)`` on batches the
port solves: the ``mknapcb9`` law (``lpbench/traffic/mknap.py``) at a small
width and at 30 x 500, and random batches of both senses whose bounds hold
``+inf`` and ``0`` entries, in float32 and float64, with one bound row for
the batch or one an instance.  Failures are planted in chosen instances (a
wrong ``at_upper`` flag that breaks a dual sign, a basic ``x_j`` beyond its
bound, a non-optimal status, a basis index past ``n + m``, a singular
basis), and ``at_upper`` is claimed on a basic column of another, which
must be ignored: the same verdicts as the host copy's pre-escalation ones
(``~escalated``), and ``x``, ``fun`` and ``z`` within 1e-12 of the
instance's scale.  ``_certify_on_device`` on CPU tensors against
``certify_uniform_result`` on the whole bounded batch: equal statuses,
certification and escalation flags and ``at_upper``; its fallback's
sub-batch carries the bad instances' ``ub`` and ``at_upper`` rows.

On a card (``gpu``; this file imports no JAX, so ``--noconftest`` runs it
there): the kernel against the twin, and ``solve_arrays`` launching it once
a call on a bounded batch and reaching the CPU path's verdicts.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_parity import CPU

import simplex_tpu_torch as pt
from lpbench.traffic import mknap
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.models import certify as tcert
from simplex_tpu_torch.ops import certify_kernel as ck

LAW = {"weights": [0, 1000], "tightness": [0.25, 0.5, 0.75],
       "profit_spread": 500.0, "ub": 1.0, "pool": 1}

# name -> (law, seed, B, m, n, dtype of the inputs, ub one row a batch)
CASES = {
    "mknap-m5x40": ("mknap", 2**31 + 21, 64, 5, 40, np.float32, False),
    "mknap-m30x500": ("mknap", 2**31 + 22, 8, 30, 500, np.float32, False),
    "random-m1": ("random", 23, 256, 1, 4, np.float32, False),
    "random-m5x9": ("random", 24, 256, 5, 9, np.float32, False),
    "random-m5x9-one-ub-row": ("random", 25, 256, 5, 9, np.float32, True),
    "random-m30x50": ("random", 26, 128, 30, 50, np.float32, False),
    "random-m30x50-f64-inputs": ("random", 27, 128, 30, 50, np.float64,
                                 False),
    "random-m64x80": ("random", 28, 32, 64, 80, np.float32, False),
    "random-no-finite-ub": ("unbounded", 29, 64, 5, 9, np.float32, False),
}


def _lps(law, seed, B, m, n, dtype, one_row):
    """``(c, A, b, ub, maximize)``: all rows ``<=``, ``b >= 0``."""
    if law == "mknap":
        it = mknap.item(dict(LAW, batch=B, m=m, n=n, dtype="float32"),
                        seed, 0)
        return (it["c"].astype(dtype), it["A"].astype(dtype),
                it["b"].astype(dtype), it["ub"].astype(dtype),
                np.ones(B, bool))
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (B, m, n))
    b = rng.uniform(1.0, 5.0, (B, m))
    c = rng.uniform(-1.0, 1.0, (B, n))
    maxi = rng.random(B) < 0.5
    draw = rng.random((1 if one_row else B, n))
    ub = np.where(draw < 0.2, np.inf, np.where(draw < 0.3, 0.0,
                                               rng.uniform(0.2, 2.0,
                                                           draw.shape)))
    if law == "unbounded":
        ub[:] = np.inf
    ub = ub[0] if one_row else ub
    return (c.astype(dtype), A.astype(dtype), b.astype(dtype),
            ub.astype(dtype), maxi)


def _kkt(c, A, b, ub, maxi, basis, at_upper, i):
    """Instance ``i``'s basis matrix, ``x_B`` and reduced costs in float64
    (numpy), from its basis and at-upper state."""
    m, n = A.shape[1:]
    Ai = A[i].astype(np.float64)
    bidx = basis[i, :m]
    struct = bidx < n
    Bm = np.where(struct[None, :], Ai[:, np.where(struct, bidx, 0)],
                  np.arange(m)[:, None] == bidx[None, :] - n)
    c_min = np.where(maxi[i], -1.0, 1.0) * c[i].astype(np.float64)
    u_i = np.broadcast_to(ub, (len(maxi), n))[i].astype(np.float64)
    up = np.zeros(n, bool) if at_upper is None else at_upper[i, :n].copy()
    up &= np.isfinite(u_i)
    up[bidx[struct]] = False
    x_B = np.linalg.solve(Bm, b[i] - Ai @ np.where(up, u_i, 0.0))
    y = np.linalg.solve(Bm.T, np.where(struct, c_min[np.where(struct, bidx,
                                                              0)], 0.0))
    return Bm, x_B, c_min - y @ Ai, up, u_i


def _plant(res, c, A, b, ub, maxi):
    """Plant one failure of each kind (claims and ``b`` changed in place;
    returns the new ``b``, the planted instances and ``(i, j)``: instance
    ``i`` has ``at_upper`` claimed on its basic column ``j`` and stays
    certified)."""
    B, m, n = A.shape
    basis, status, at_upper = res.basis, res.status, res.at_upper
    status[0] = 3                                      # unbounded claim
    basis[1, 0] = n + m                                # past the end
    basis[2, :2] = n                                   # singular
    planted = [0, 1, 2] if m >= 2 else [0, 1]
    b = b.copy()
    tol = tmb._CERT_TOL
    flag = bound = ignored = None
    for i in range(3, B):
        if status[i] != 0:
            continue
        bidx = basis[i, :m]
        Bm, x_B, rc, up, u_i = _kkt(c, A, b, ub, maxi, basis, at_upper, i)
        c_scale = 1.0 + np.abs(c[i]).max()
        basic = np.zeros(n, bool)
        basic[bidx[bidx < n]] = True
        # A column at its lower bound that prices out strongly, claimed at
        # its upper one: its reduced cost fails the upper sign test.
        cand = np.flatnonzero(~basic & ~up & np.isfinite(u_i) & (u_i > 0)
                              & (rc > 1e3 * tol * c_scale))
        if flag is None and at_upper is not None and len(cand):
            at_upper[i, cand[0]] = True
            flag = i
            continue
        # A basic x_j moved beyond its finite bound: b + t B e_k leaves y
        # and every other x_B as they were.
        ks = np.flatnonzero((bidx < n) & np.isfinite(
            u_i[np.where(bidx < n, bidx, 0)]))
        if bound is None and len(ks):
            k = ks[0]
            over = 1e-3 * (1.0 + np.abs(b[i]).max())
            t = u_i[bidx[k]] + over - x_B[k]
            b[i] = (b[i].astype(np.float64) + t * Bm[:, k]).astype(b.dtype)
            assert (b[i] >= 0).all()
            bound = i
            continue
        if ignored is None and len(ks) and at_upper is not None:
            ignored = (i, bidx[ks[0]])
            at_upper[ignored] = True
        if flag is not None and bound is not None and ignored is not None:
            break
    planted += [i for i in (flag, bound) if i is not None]
    return b, sorted(planted), ignored


@functools.lru_cache(maxsize=None)
def _solved(case):
    """The case's LPs and their CPU solve (in float64, uncertified), with
    the failures planted."""
    law, seed, B, m, n, dtype, one_row = CASES[case]
    c, A, b, ub, maxi = _lps(law, seed, B, m, n, dtype, one_row)
    res = pt.BatchedSimplexSolver(pt.SolverConfig(
        device=CPU, certify=False, dtype="float64")).solve_arrays(
            c, A, b, np.full(m, -1), maximize=maxi, ub=ub)
    res.basis = np.array(res.basis)
    res.status = np.array(res.status)
    if res.at_upper is not None:
        res.at_upper = np.array(res.at_upper)
    b, planted, ignored = _plant(res, c, A, b, ub, maxi)
    return c, A, b, ub, maxi, res, planted, ignored


def _fresh(case):
    c, A, b, ub, maxi, res, planted, ignored = _solved(case)
    res = dataclasses.replace(
        res, basis=res.basis.copy(), status=res.status.copy(),
        x=res.x.copy(), z=res.z.copy(), fun=res.fun.copy(),
        at_upper=None if res.at_upper is None else res.at_upper.copy())
    return c, A, b, ub, maxi, res, planted, ignored


def _tensors(c, A, b, ub, maxi, res, device):
    """The certifier's arguments on ``device``: the tolerance the solve
    passes (the host copy's) before ``ub`` and ``at_upper``."""
    t = functools.partial(torch.as_tensor, device=device)
    return (t(A), t(b), t(c), t(maxi), t(res.basis.astype(np.int32)),
            t(res.status.astype(np.int32)), tmb._CERT_TOL, t(ub),
            None if res.at_upper is None else t(res.at_upper))


def _close(got, want, scale):
    """Equal NaN patterns, and within 1e-12 of ``1 + scale``."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    tol = 1e-12 * (1.0 + np.broadcast_to(scale, want.shape))
    assert np.all(np.abs(got[fin] - want[fin]) <= tol[fin])


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_agrees_with_the_host_certifier(case):
    c, A, b, ub, maxi, res, planted, ignored = _fresh(case)
    ok, x, fun = (t.numpy() for t in ck.certify_le_ref(
        *_tensors(c, A, b, ub, maxi, res, CPU)))
    host = tcert.certify_sweep_le_f64(res.status, res.basis, c, A, b, maxi,
                                      ub=ub, at_upper=res.at_upper)
    np.testing.assert_array_equal(ok, ~host["escalated"])
    # Every planted claim fails, and nothing else; both kinds of bound
    # failure are planted where the batch has bounds to break.
    np.testing.assert_array_equal(np.flatnonzero(~ok), planted)
    bounded = res.at_upper is not None
    assert len(planted) == (3 if A.shape[1] >= 2 else 2) + 2 * bounded
    assert bounded == (ignored is not None)
    if bounded:
        assert ok[ignored[0]] and res.at_upper[ignored]
    xs = np.abs(np.where(ok[:, None], x, 0.0)).max(1)
    _close(x[ok], host["x"][ok], xs[ok][:, None])
    _close(fun[ok], host["fun"][ok], np.abs(fun[ok]))
    z = np.where(maxi, -fun, fun) + 0.0
    _close(z[ok], host["z"][ok], np.abs(z[ok]))
    assert np.isnan(x[~ok]).all() and np.isnan(fun[~ok]).all()


def test_at_upper_on_a_basic_column_changes_nothing():
    """The claim planted on a basic column is ignored: the instance's
    verdict and ``x`` are those without it."""
    c, A, b, ub, maxi, res, _, (i, j) = _fresh("random-m30x50")
    args = list(_tensors(c, A, b, ub, maxi, res, CPU))
    ok, x, fun = ck.certify_le_ref(*args)
    res.at_upper[i, j] = False
    args[8] = torch.as_tensor(res.at_upper)
    ok2, x2, fun2 = ck.certify_le_ref(*args)
    assert ok[i] and ok2[i]
    assert torch.equal(x[i], x2[i]) and fun[i] == fun2[i]


def _host_path(case):
    """``_certify_on_device`` (CPU tensors, the twin doing the kernel's
    part) and ``certify_uniform_result``, each followed by
    ``_reset_at_upper`` as ``solve_arrays`` follows them."""
    c, A, b, ub, maxi, res, planted, _ = _fresh(case)
    m = A.shape[1]
    ops = np.full(m, -1)
    tensors, maxi_np, _ = tmb._upload(c, A, b, ops, maxi, np.float32, CPU)
    host_res = dataclasses.replace(
        res, status=res.status.copy(), x=res.x.copy(), z=res.z.copy(),
        fun=res.fun.copy(),
        at_upper=None if res.at_upper is None else res.at_upper.copy())
    before = tcert.ESCALATIONS
    want = tmb._reset_at_upper(tmb.certify_uniform_result(
        host_res, c, A, b, ops, maxi, ub=ub), ub)
    host_escalations = tcert.ESCALATIONS - before
    before = tcert.ESCALATIONS
    got = tmb._reset_at_upper(tmb._certify_on_device(
        res, c, A, b, ops, maxi_np, tensors, ub=ub), ub)
    assert tcert.ESCALATIONS - before == host_escalations == len(planted)
    return got, want, planted


@pytest.mark.parametrize("case", ["mknap-m5x40", "random-m5x9-one-ub-row",
                                  "random-m30x50-f64-inputs",
                                  "random-no-finite-ub"])
def test_certify_on_device_matches_the_host_path(case):
    got, want, planted = _host_path(case)
    for name in ("status", "certified", "escalated", "success"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(np.flatnonzero(got.escalated), planted)
    if want.at_upper is None:
        assert got.at_upper is None
    else:
        np.testing.assert_array_equal(got.at_upper, want.at_upper)
    scale = np.abs(np.nan_to_num(want.x)).max(1, keepdims=True)
    _close(got.x, want.x, scale)
    _close(got.z, want.z, np.abs(np.nan_to_num(want.z)))


@pytest.mark.parametrize("case", ["mknap-m5x40", "random-m5x9-one-ub-row"])
def test_the_fallback_carries_its_bounds(case, monkeypatch):
    """The sub-batch handed to the host copy holds the bad instances'
    ``at_upper`` rows and their ``ub`` (the batch's one row as it is)."""
    c, A, b, ub, maxi, res, planted, _ = _fresh(case)
    seen = []
    host = tmb.certify_uniform_result

    def spy(sub, *args, **kw):
        seen.append((sub.at_upper.copy(), kw["ub"]))
        return host(sub, *args, **kw)

    monkeypatch.setattr(tmb, "certify_uniform_result", spy)
    ops = np.full(A.shape[1], -1)
    tensors, maxi_np, _ = tmb._upload(c, A, b, ops, maxi, np.float32, CPU)
    at_upper = res.at_upper.copy()
    from simplex_tpu_torch.utils import profiling

    with profiling.solve_record("test.fallback") as rec:
        tmb._certify_on_device(res, c, A, b, ops, maxi_np, tensors, ub=ub)
    assert rec["counts"]["certify_fallback"] == len(planted)
    assert [s[0] for s in rec["spans"]].count("certify.device") == 1
    (sub_up, sub_ub), = seen
    np.testing.assert_array_equal(sub_up, at_upper[planted])
    np.testing.assert_array_equal(sub_ub, ub if ub.ndim == 1
                                  else ub[planted])


def test_the_route_takes_cuda_le_batches_with_bounds():
    cuda = type("FakeCuda", (), {"type": "cuda"})()

    class T:
        device = cuda

        def __init__(self, shape):
            self.shape = shape

    A, b, ops = T((2, 3, 4)), np.ones((2, 3)), np.full(3, -1)
    for ub in (np.ones(4), np.full((2, 4), np.inf), np.zeros((2, 4)),
               [1.0, np.inf, 0.0, 2.0]):
        assert tmb._certifies_on_device(A, b, ops, ub)
    for ub in (-np.ones(4), np.full(4, np.nan), np.ones((1, 4)),
               np.ones((2, 5)), np.ones(3)):
        assert not tmb._certifies_on_device(A, b, ops, ub)
    assert not tmb._certifies_on_device(A, -b, ops, np.ones(4))
    assert not tmb._certifies_on_device(torch.zeros((2, 3, 4)), b, ops,
                                        np.ones(4))         # CPU tensors


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    c, A, b, ub, maxi, res, _, _ = _fresh("random-m5x9")
    args = list(_tensors(c, A, b, ub, maxi, res, CPU))
    bad = {7: [args[7].double().half(), args[7][:, :-1], args[7][None],
               args[7].t().contiguous().t()],
           8: [args[8].to(torch.uint8), args[8][:, :A.shape[2] - 1],
               args[8][:1]]}
    for pos, values in bad.items():
        for v in values:
            with pytest.raises((TypeError, ValueError)):
                ck.certify_le_(*args[:pos], v, *args[pos + 1:])
    ok, _, _ = ck.certify_le_(*args[:8], None)
    assert ok.dtype == torch.bool and ok.shape == (A.shape[0],)


# ---------------------------------------------------------------- card --- #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _cuda_solved(law, seed, B, m, n):
    c, A, b, ub, maxi = _lps(law, seed, B, m, n, np.float32, False)
    res = pt.BatchedSimplexSolver(pt.SolverConfig(certify=False)) \
        .solve_arrays(c, A, b, np.full(m, -1), maximize=maxi, ub=ub)
    res.basis = np.array(res.basis)
    res.status = np.array(res.status)
    res.at_upper = np.array(res.at_upper)
    b, planted, ignored = _plant(res, c, A, b, ub, maxi)
    return c, A, b, ub, maxi, res, planted


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [("mknap", 2048, 30, 500),
                                   ("random", 64, 1, 3),
                                   ("random", 256, 5, 9),
                                   ("random", 128, 30, 50),
                                   ("random", 48, 64, 80),
                                   ("random", 64, 30, 1001)])
def test_kernel_matches_the_twin(shape):
    """``n`` = 9 and 1001 leave A's rows off 16-byte boundaries (one
    element a copy); the others copy 16-byte pieces."""
    _card()
    law, B, m, n = shape
    c, A, b, ub, maxi, res, planted = _cuda_solved(law, 31, B, m, n)
    for dt in (np.float32, np.float64):
        args = (c.astype(dt), A.astype(dt), b, ub.astype(dt), maxi, res)
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
def test_solve_arrays_certifies_bounded_batches_on_the_card():
    _card()
    for law, seed, B, m, n, dt in (("mknap", 32, 64, 30, 500, np.float32),
                                   ("random", 33, 2048, 30, 50, np.float32),
                                   ("random", 34, 512, 30, 50, np.float64),
                                   ("random", 35, 256, 64, 80, np.float32)):
        c, A, b, ub, maxi = _lps(law, seed, B, m, n, dt, False)
        ops = np.full(m, -1)
        before = ck.LAUNCHES_CERT
        gpu = pt.BatchedSimplexSolver(pt.SolverConfig()).solve_arrays(
            c, A, b, ops, maximize=maxi, ub=ub)
        assert ck.LAUNCHES_CERT == before + 1
        cpu = pt.BatchedSimplexSolver(pt.SolverConfig(device=CPU)) \
            .solve_arrays(c, A, b, ops, maximize=maxi, ub=ub)
        np.testing.assert_array_equal(gpu.status, cpu.status)
        np.testing.assert_array_equal(gpu.certified, cpu.certified)
        assert gpu.certified.all()
        ok = cpu.status == 0
        assert np.all(np.abs(gpu.z[ok] - cpu.z[ok])
                      <= 1e-6 * (1 + np.abs(cpu.z[ok])))

