"""The batched and dense solve cells (port of ``bench.py``'s
``bench_batched_solve``, ``bench_bounded_batched`` and
``bench_dense_solve``).

Each function returns bench.py's record: ``metric``, ``value``, ``unit``,
``vs_baseline`` and ``detail`` under bench.py's keys, from bench.py's
generators, seeds and defaults.  The two batched cells time the device
solve on staged inputs (``phase2_only=True``, as bench.py) with CUDA
events (``utils/pivot_bench.rep_times``), the median of ``reps``.  The
loops replay CUDA graphs (``runtime/graphs.py``) and a shape's first solve
also captures them, so one solve runs before the timed ones and its
seconds, captures included, go into ``detail["first_solve_s"]``; every
timed repetition's seconds go into ``detail["rep_s"]``.  Whole solves
with their host work (``solve_arrays``, ``solve_lp``) are timed on the
host clock.  ``detail["backend"]`` names the kernel that ran (``"K2"``,
``"K3"``; their plain twins, ``"K2 twin"`` / ``"K3 twin"``, on a CPU
tensor) where bench.py names the Pallas or XLA backend.  Keys added to
bench.py's: ``first_solve_s``, ``rep_s``, ``device``, and ``backend`` in
the bounded cell.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..config import SolverConfig, torch_device
from ..core.problem import LinearProgram
from ..models.batched import (BatchedSimplexSolver, compile_batch_on_device,
                              compile_batch_uniform)
from ..models.dense import solve_lp
from ..ops.batched import (batch_state_from_compiled, solve_tableau_batch,
                           solve_tableau_batch_bounded)
from .pivot_bench import device_name, median_spread, rep_times


def lp_batch(B: int, m: int = 30, n: int = 50, bounded: bool = False):
    """bench.py's batched LPs (seed 0): ``A x <= b`` with A ~ U(0.05, 1),
    b ~ U(1, 5), c ~ U(0.1, 1), float32, maximized; with ``bounded`` also
    ``ub``, 60 % of the variables bounded by U(1, 3) (the rest +inf).
    Returns ``(c, A, b, ops)`` or ``(c, A, b, ops, ub)``."""
    rng = np.random.default_rng(0)
    A = rng.uniform(0.05, 1.0, size=(B, m, n)).astype(np.float32)
    b = rng.uniform(1.0, 5.0, size=(B, m)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, size=(B, n)).astype(np.float32)
    ops = np.full((m,), -1)
    if not bounded:
        return c, A, b, ops
    ub = np.where(rng.random((B, n)) < 0.6,
                  rng.uniform(1.0, 3.0, (B, n)), np.inf).astype(np.float32)
    return c, A, b, ops, ub


def dense_lp(size: int) -> LinearProgram:
    """bench.py's dense LP (seed 0): ``size`` x ``size``, A ~ U(0.05, 1),
    b ~ U(0.3 m, 0.6 m), c ~ U(0.1, 1), all ``<=``, maximized."""
    rng = np.random.default_rng(0)
    m = n = size
    A = rng.uniform(0.05, 1.0, size=(m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    return LinearProgram(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True)


def kernel_name(kernel: str, device) -> str:
    """The kernel a batched solve on ``device`` runs: ``kernel`` on a card,
    its plain twin on the CPU."""
    return kernel if torch.device(device).type == "cuda" else kernel + " twin"


def _timed_solves(one, reps: int, dev) -> Dict:
    """One solve (captures included), then ``reps`` timed ones: the
    median seconds, the spread and both raw figures."""
    first = rep_times(one, 1, dev)[0]
    ts = rep_times(one, reps, dev)
    dt, spread = median_spread(ts)
    return {"dt": dt, "spread": spread, "first": first, "ts": ts}


def _no_tf32(dev):
    if dev.type == "cuda":
        # The refactor's and the polish's products in full f32, as the
        # solvers run them (TF32 keeps about three digits).
        torch.backends.cuda.matmul.allow_tf32 = False


def bench_batched_solve(B: int = 1024, m: int = 30, n: int = 50,
                        reps: int = 3, device="cuda") -> Dict:
    """Batched LPs solved a second on one card (BASELINE config 2's shape).

    ``value``: B over the device solve (``solve_tableau_batch`` with
    ``phase2_only=True``, K2 on a card) on inputs compiled on the host and
    staged on the card.  ``vs_baseline``: the optimal share of a certified
    ``BatchedSimplexSolver.solve_arrays`` of the same batch, whose second
    run's wall (assembly, solve, f64 certification) is
    ``end_to_end_wall_s``.  ``device`` is the card by default (it raises
    where there is none); ``"cpu"`` runs the twin.
    """
    dev = torch_device(device)
    _no_tf32(dev)
    c, A, b, ops = lp_batch(B, m, n)
    solver = BatchedSimplexSolver(SolverConfig(device=str(dev)))
    res = solver.solve_arrays(c, A, b, ops, maximize=True)  # captures
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True)
    wall = time.perf_counter() - t0

    cb = compile_batch_uniform(c, A, b, ops, maximize=True)
    st = batch_state_from_compiled(cb, dev, torch.float32)

    def one():
        # phase2_only is what solve_arrays selects for this all-<= batch.
        out = solve_tableau_batch(**st, phase2_only=True)
        float(out[0].sum())

    t = _timed_solves(one, reps, dev)
    return {
        "metric": f"batched_lps_per_sec_{B}x{m}x{n}",
        "value": B / t["dt"],
        "unit": "LPs/s/chip",
        "vs_baseline": res.n_optimal / B,
        "detail": {"device_solve_s": t["dt"],
                   "end_to_end_wall_s": wall,
                   "backend": kernel_name("K2", dev),
                   "n_reps": reps,
                   "spread": t["spread"],
                   "n_optimal": res.n_optimal,
                   "pivot_iters": res.nit,
                   "mean_pivots": (None if res.pivots is None
                                   else float(np.mean(res.pivots))),
                   "first_solve_s": t["first"],
                   "rep_s": t["ts"],
                   "device": device_name(dev)},
    }


def bench_bounded_batched(B: int = 1024, m: int = 30, n: int = 50,
                          reps: int = 3, device="cuda") -> Dict:
    """The bounded batch (``solve_tableau_batch_bounded``, K3 on a card):
    LPs a second with about 60 % of the variables bounded, on inputs
    assembled on the card; ``vs_baseline`` the optimal share of the
    warm-up solve."""
    dev = torch_device(device)
    _no_tf32(dev)
    c, A, b, ops, ub = lp_batch(B, m, n, bounded=True)
    cb = compile_batch_on_device(c, A, b, ops, True, ub=ub, device=dev)
    st = batch_state_from_compiled(cb, dev, torch.float32)
    outs = []

    def one():
        out = solve_tableau_batch_bounded(**st, phase2_only=True)
        float(out[0].sum())
        outs.append(out)

    t = _timed_solves(one, reps, dev)
    n_opt = int((outs[0][3] == 0).sum())
    return {
        "metric": f"bounded_batched_lps_per_sec_{B}x{m}x{n}",
        "value": B / t["dt"],
        "unit": "LPs/s/chip",
        "vs_baseline": n_opt / B,
        "detail": {"device_solve_s": t["dt"], "n_reps": reps,
                   "spread": t["spread"], "n_optimal": n_opt,
                   "backend": kernel_name("K3", dev),
                   "first_solve_s": t["first"], "rep_s": t["ts"],
                   "device": device_name(dev)},
    }


def bench_dense_solve(size: int = 2048, device="cuda") -> Dict:
    """One dense LP solved end to end (``solve_lp``: presolve, the
    two-phase loop on K1, refactors, f64 finalize), as pivots a second of
    the second solve's wall; the first solve's wall, captures included,
    is ``first_solve_s``."""
    dev = torch_device(device)
    lp = dense_lp(size)
    cfg = SolverConfig(device=str(dev))
    t0 = time.perf_counter()
    res = solve_lp(lp, cfg)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_lp(lp, cfg)
    dt = time.perf_counter() - t0
    pivots = max(res.nit, 1)
    return {
        "metric": f"dense_solve_pivots_per_sec_{size}x{size}",
        "value": pivots / dt,
        "unit": "pivots/s/chip (full loop)",
        "vs_baseline": 1.0 if res.success else 0.0,
        "detail": {"wall_s": dt, "pivots": res.nit, "status": res.status,
                   "z": None if res.z is None else float(res.z),
                   "first_solve_s": first, "device": device_name(dev)},
    }
