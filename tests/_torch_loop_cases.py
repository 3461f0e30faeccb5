"""Small runs of each solve loop of the PyTorch port, on any device.

Every loop of the port runs its chunk of device steps through
``simplex_tpu_torch/runtime/graphs.py``: eagerly on the CPU, as one CUDA
graph on the card.  Each case here builds one loop's inputs with the port
alone (no JAX) from a seed of ``_torch_parity.py``, runs the loop on
``device`` and returns what it returns as numpy arrays and ints, so that
two runs can be held equal bit for bit: the chunk bodies against the
loops' recorded results on the CPU (``test_torch_graphs.py``), and graph
against eager on the card.  Refactor periods are short, so every case runs
several chunks.
"""
import numpy as np
import torch

from _torch_parity import MIXED_OPS, random_batch, random_ub, seeded_lp

from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.core.problem import (
    LinearProgram,
    compile_standard_form,
    normalize_bounds,
)
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.models import dense as td
from simplex_tpu_torch.models import pdhg as tp
from simplex_tpu_torch.models import revised as t_rev
from simplex_tpu_torch.ops import batched as tb
from simplex_tpu_torch.ops import tableau as tt
from simplex_tpu_torch.parallel import sharded as ps


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(**kw):
    return {k: _np(v) for k, v in kw.items()}


def dense_inputs(seed=5):
    """The standard form of :func:`dense_phase` and its solve options."""
    sf = compile_standard_form(LinearProgram(**seeded_lp(seed)),
                               dtype=np.float64)
    return sf, dict(need_phase1=sf.need_phase1, tol=1e-9, refactor_every=6)


def dense_phase(device, dtype, seed=5, devex=True):
    """``solve_tableau`` (``_run_phase``, both phases) on a mixed-row LP."""
    sf, kw = dense_inputs(seed)
    st = tt.state_from_standard_form(sf, device, dtype)
    T, basis, status, iters = tt.solve_tableau(**st, **kw, devex=devex)
    return _out(T=T, basis=basis, status=status, iters=iters)


def _scaled_lp(seed, m=24, n=16):
    rng = np.random.default_rng(seed)
    rowscale = 10.0 ** rng.uniform(-1.5, 1.5, m)
    A = rng.uniform(0.1, 1.0, size=(m, n)) * rowscale[:, None]
    b = rng.uniform(m * 0.3, m * 0.6, size=m) * rowscale
    c = rng.uniform(0.1, 1.0, size=n)
    return dict(c=c, A=A, ops=np.full(m, -1), maximize=True), b, \
        b * rng.uniform(0.6, 1.0, m)


def dual_inputs(seed=20):
    """:func:`dual`'s start as numpy arrays ``(T0, basis, col_mask)`` and
    its options: the old optimal basis refactored under a shrunk RHS, as
    ``reoptimize`` starts it."""
    kw, b, b2 = _scaled_lp(seed)
    cpu64 = SolverConfig(device="cpu", dtype="float64")
    basis = td.solve_lp(LinearProgram(b=b, **kw), cpu64).basis
    lp2 = LinearProgram(b=b2, **kw)
    row_pad, col_pad = td._pad_plan(lp2)
    sf = compile_standard_form(lp2, row_pad=row_pad, col_pad=col_pad,
                               dtype=np.float64)
    rows = sf.tableau[:sf.m_pad]
    T_rows = np.linalg.solve(rows[:, basis], rows)
    obj = sf.obj_row_p2 - sf.obj_row_p2[basis] @ T_rows
    T0 = np.concatenate([T_rows, obj[None]])
    return (T0, np.asarray(basis, np.int64), sf.col_mask_p2), dict(
        tol=1e-9, max_iters=500, bland_after=250, refactor_every=4)


def dual(device, dtype, seed=20, devex=True):
    """``solve_tableau_dual`` (``_run_dual``) from the old optimal basis
    refactored under a shrunk RHS, as ``reoptimize`` starts it."""
    (T0, basis, cm), kw = dual_inputs(seed)
    T, basis, status, iters = tt.solve_tableau_dual(
        torch.as_tensor(T0, device=device).to(dtype),
        torch.as_tensor(basis, device=device),
        torch.as_tensor(cm, device=device), devex=devex, **kw)
    return _out(T=T, basis=basis, status=status, iters=iters)


def dual_bounded_inputs(seed=405):
    """:func:`dual_bounded`'s start as numpy arrays ``(T0, basis,
    col_mask, ub, at_upper)`` and its options: an RHS increase that pushes
    basics above their upper bounds, from a revised parent."""
    rng = np.random.default_rng(seed)
    m, n = 24, 16
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.2, 1.5, size=n)
    b = A @ x0 + rng.uniform(0.05, 0.4, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    ub = np.where(rng.random(n) < 0.6, x0 * rng.uniform(0.7, 1.6, n),
                  np.inf)
    b2 = b * (1.0 + rng.uniform(0.05, 0.25, size=m))
    kw = dict(c=c, A=A, ops=np.full(m, -1), maximize=True, ub=ub)
    parent = t_rev.RevisedSimplexSolver(SolverConfig(
        device="cpu", dtype="float64", presolve=False)).solve(
            LinearProgram(b=b, **kw))
    lp_t, _ = normalize_bounds(LinearProgram(b=b2, **kw))
    sf = compile_standard_form(lp_t, dtype=np.float64, bounded=True)
    k = sf.n_pad
    atu = np.asarray(parent.at_upper, bool)[:k] & np.isfinite(sf.ub_ext[:k])
    atu[parent.basis] = False
    T0 = np.concatenate([sf.tableau[:sf.m_pad], sf.obj_row_p2[None]])
    return (T0, np.asarray(parent.basis, np.int64), sf.col_mask_p2,
            sf.ub_ext, atu), dict(tol=1e-9, max_iters=500, bland_after=250,
                                  refactor_every=3)


def dual_bounded(device, dtype, seed=405, devex=True):
    """``solve_tableau_dual_bounded`` after an RHS increase that pushes
    basics above their upper bounds, from a revised parent."""
    (T0, basis, cm, ub, atu), kw = dual_bounded_inputs(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    T, basis, at_upper, status, iters = tt.solve_tableau_dual_bounded(
        dev(T0).to(dtype), dev(basis), dev(cm), dev(ub).to(dtype), dev(atu),
        devex=devex, **kw)
    return _out(T=T, basis=basis, at_upper=at_upper, status=status,
                iters=iters)


def batch_inputs(ops, ub, devex):
    """The ``CompiledBatch`` (numpy arrays) of a batched case and its
    options, without the backend."""
    c, A, b, ops = random_batch(11, ops=ops)
    ubs = None if not ub else random_ub(12, (c.shape[0], c.shape[1]), 0.5,
                                        2.0, frac=0.6)
    cb = tmb.compile_batch_uniform(c, A, b, ops, maximize=True, ub=ubs)
    return cb, dict(tol=1e-9, refactor_every=5, devex=devex,
                    phase2_only=not bool(np.any(cb.need_p1)))


def _batch(ops, ub, backend, devex, device, dtype):
    cb, kw = batch_inputs(ops, ub, devex)
    st = tb.batch_state_from_compiled(cb, device, dtype)
    if ub:
        T, basis, at_upper, status, iters, pivots = \
            tb.solve_tableau_batch_bounded(**st, backend=backend, **kw)
        return _out(T=T, basis=basis, at_upper=at_upper, status=status,
                    iters=iters, pivots=pivots)
    T, basis, status, iters, pivots = tb.solve_tableau_batch(
        **st, backend=backend, **kw)
    return _out(T=T, basis=basis, status=status, iters=iters, pivots=pivots)


def batched_mixed(device, dtype, backend="auto"):
    """The general (two-phase) loop with phase flips: K2 or its twin."""
    return _batch(MIXED_OPS, False, backend, True, device, dtype)


def batched_le(device, dtype, backend="auto"):
    """The ``phase2_only`` loop (every row ``<=``)."""
    return _batch(None, False, backend, False, device, dtype)


def bounded_mixed(device, dtype, backend="auto"):
    """The bounded general loop: K3 or its twin, bound flips."""
    return _batch(MIXED_OPS, True, backend, True, device, dtype)


def bounded_le(device, dtype, backend="auto"):
    """The bounded ``phase2_only`` loop."""
    return _batch(None, True, backend, True, device, dtype)


def revised_inputs(seed=7):
    """:func:`revised`'s standard-form arrays (numpy): ``A``, ``b``,
    ``ub``, the starting ``basis``, the artificial mask, each phase's
    ``(in_phase2, cost, col_mask)``, and the options."""
    kw = seeded_lp(seed)
    rng = np.random.default_rng(seed)
    n = len(kw["c"])
    kw["ub"] = np.where(rng.random(n) < 0.5, rng.uniform(0.5, 2.5, n),
                        np.inf)
    lp, _ = normalize_bounds(LinearProgram(**kw))
    sf = compile_standard_form(lp, dtype=np.float64, bounded=True)
    m, k = sf.m_pad, sf.n_pad
    ub = sf.ub_ext if sf.ub_ext is not None else np.full(k, np.inf)
    art = np.concatenate([sf.col_mask_p1 & ~sf.col_mask_p2,
                          np.ones(m, bool)])[:k]
    phases = [(False, sf.obj_row_p1[:k + 1], sf.col_mask_p1),
              (True, sf.obj_row_p2[:k + 1], sf.col_mask_p2)]
    return (sf.tableau[:m, :k], sf.tableau[:m, k], ub,
            np.asarray(sf.basis, np.int64), art, phases), dict(
                tol=1e-9, max_iters=400, bland_after=60, refactor_every=8)


def revised(device, dtype, seed=7, devex=True):
    """``_run_phase_revised``: phase 1, then phase 2 from its end, on a
    mixed-row LP with upper bounds (refactors every 8 steps)."""
    (A, b, ub, basis, art, phases), kw = revised_inputs(seed)

    def dev(a, dt=None):
        t = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return t if dt is None else t.to(dt)

    A, b, ub_t = dev(A, dtype), dev(b, dtype), dev(ub, dtype)
    basis = dev(basis)
    at_up = torch.zeros(A.shape[1], dtype=torch.bool, device=device)
    state = t_rev._refactor(A, b, basis, at_up, ub_t) + (basis, at_up)
    out, iters = {}, 0
    for phase2, cost, cm in phases:
        res = t_rev._run_phase_revised(
            A, b, dev(cost, dtype), dev(cm), dev(art), *state, ub_t,
            iters, phase2, devex=devex, **kw)
        state, iters = res[:4], res[4]
        out.update({f"{name}{int(phase2)}": v for name, v in zip(
            ("B_inv", "x_B", "basis", "at_upper", "iters", "status", "obj"),
            res)})
    return _out(**out)


def pdhg(device, dtype, bounded=True):
    """``_pdhg_solve`` to its cap (checks every 40 iterations)."""
    c, A, b, _ = random_batch(3, B=8, m=10, n=6)
    is_eq = np.zeros(b.shape, bool)
    is_eq[:, 0] = True
    ub = None
    if bounded:
        rng = np.random.default_rng(4)
        ub = torch.as_tensor(np.where(rng.random((8, 6)) < 0.7,
                                      rng.uniform(0.5, 1.8, (8, 6)), np.inf),
                             device=device).to(dtype)

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    x, y, primal, dual_, gap, done, iters = tp._pdhg_solve(
        dev(A), dev(b), dev(-c), torch.as_tensor(is_eq, device=device), ub,
        max_iters=457, tol=1e-6, bounded=bounded)
    return _out(x=x, y=y, primal=primal, dual=dual_, gap=gap, done=done,
                iters=iters)


def sharded(device, dtype, bounded=True):
    """``solve_tableau_sharded`` on the 1x1 mesh without a process group
    (a resync every 5 steps): ``_torch_sharded_worker.py``'s two-phase
    batch, or its bounded batch with mixed rows, at 40 and 48 rows."""
    import _torch_sharded_worker as worker

    raw = (worker.CASES["native_bounds"](m=48, n=20) if bounded
           else worker.CASES["two_phase"](m=40, n=20))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    _, arrays, is_bounded = ps.compile_sharded(
        raw["c"], raw["A"], raw["b"], raw["ops"], raw["maximize"], 1, 1,
        dtype=np_dt, ub=raw["ub"])
    mesh = ps.make_mesh(1, 1)
    T, basis, obj, status, iters, at_upper = ps.solve_tableau_sharded(
        *ps.stage_shards(arrays, mesh, device), mesh=mesh, refactor_every=5,
        bounded=is_bounded)
    return _out(T=T, basis=basis, obj=obj, status=status, iters=iters,
                at_upper=at_upper)


CASES = {
    "dense_phase": dense_phase,
    "dense_phase_dantzig": lambda d, t: dense_phase(d, t, seed=8,
                                                    devex=False),
    "dual": dual,
    "dual_bounded": dual_bounded,
    "batched_mixed": batched_mixed,
    "batched_le": batched_le,
    "batched_mixed_unfused": lambda d, t: batched_mixed(d, t, "xla"),
    "bounded_mixed": bounded_mixed,
    "bounded_le": bounded_le,
    "bounded_mixed_unfused": lambda d, t: bounded_mixed(d, t, "xla"),
    "revised": revised,
    "pdhg": pdhg,
    "pdhg_classic": lambda d, t: pdhg(d, t, bounded=False),
    "sharded": sharded,
    "sharded_classic": lambda d, t: sharded(d, t, bounded=False),
}


def fingerprint(out) -> dict:
    """Each output's dtype, shape and bits as a short hash."""
    import hashlib

    return {k: f"{v.dtype}{list(v.shape)}:" + hashlib.sha256(
        np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
        for k, v in sorted(out.items())}
