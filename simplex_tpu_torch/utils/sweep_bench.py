"""The sweep cells: PDHG and the two streams (port of ``bench.py``'s
``bench_pdhg``, ``bench_stream`` and ``bench_stream_exact``).

Each function returns bench.py's record (``metric``, ``value``, ``unit``,
``vs_baseline``, ``detail`` under bench.py's keys) from bench.py's
generators, seeds (0, 100 + k, 300 + k), shapes, ``tol=1e-4`` and
``max_iters=10000``.  Device solves are timed with CUDA events
(``utils/pivot_bench.rep_times``) after one solve that also captures the
loop's CUDA graphs, whose seconds go into ``detail["first_solve_s"]``
(the streams: the cold pass, or the warm-up chunk, ``warmup_s``);
end-to-end walls are on the host clock.  Keys added to bench.py's:
``first_solve_s`` and ``rep_s`` (PDHG), ``warmup_s`` (the exact stream),
``device``; the exact stream's ``engine`` names K2.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..config import SolverConfig, torch_device
from ..models import pdhg as pdhg_mod
from ..models.batched import solve_arrays_stream
from .pivot_bench import device_name, median_spread, rep_times
from .solve_bench import kernel_name

TOL = 1e-4
MAX_ITERS = 10000


def pdhg_inputs(B: int, m: int, n: int, seed: int, device):
    """bench.py's PDHG inputs (A ~ U(0.05, 1), b ~ U(1, 5), min-form
    c ~ -U(0.1, 1), all ``<=``) as float32 tensors on ``device``:
    ``(A, b, c, is_eq)``."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(B, m, n)).astype(np.float32)
    b = rng.uniform(1.0, 5.0, size=(B, m)).astype(np.float32)
    c = -rng.uniform(0.1, 1.0, size=(B, n)).astype(np.float32)
    return (torch.from_numpy(A).to(device), torch.from_numpy(b).to(device),
            torch.from_numpy(c).to(device),
            torch.zeros((B, m), dtype=torch.bool, device=device))


def _chunks(n_chunks: int, chunk: int, m: int, n: int, seed0: int):
    """A stream's batches: chunk k from seed ``seed0 + k`` (A, b, c as in
    :func:`pdhg_inputs`, c positive: the LPs are maximized)."""
    for k in range(n_chunks):
        rng = np.random.default_rng(seed0 + k)
        A = rng.uniform(0.05, 1.0, size=(chunk, m, n)).astype(np.float32)
        b = rng.uniform(1.0, 5.0, size=(chunk, m)).astype(np.float32)
        c = rng.uniform(0.1, 1.0, size=(chunk, n)).astype(np.float32)
        yield c, A, b, np.full((m,), -1)


def bench_pdhg(B: int = 65536, m: int = 20, n: int = 30, reps: int = 3,
               device="cuda") -> Dict:
    """PDHG sweep throughput (``models/pdhg._pdhg_solve`` on staged
    inputs): LPs a second of the median device solve; ``vs_baseline`` the
    converged share."""
    dev = torch_device(device)
    args = pdhg_inputs(B, m, n, 0, dev)
    outs = []

    def one():
        out = pdhg_mod._pdhg_solve(*args, max_iters=MAX_ITERS, tol=TOL)
        float(out[0].sum())
        outs.append(out)

    first = rep_times(one, 1, dev)[0]
    ts = rep_times(one, reps, dev)
    dt, spread = median_spread(ts)
    out = outs[0]
    converged = int(out[5].sum())
    return {
        "metric": f"pdhg_lps_per_sec_{B}x{m}x{n}",
        "value": B / dt,
        "unit": "LPs/s/chip",
        "vs_baseline": converged / B,
        "detail": {"device_solve_s": dt, "n_reps": reps, "spread": spread,
                   "pdhg_iters": int(out[6]), "converged": converged,
                   "first_solve_s": first, "rep_s": ts,
                   "device": device_name(dev)},
    }


def bench_stream(total: int = 1_000_000, chunk: int = 250_000, m: int = 20,
                 n: int = 30, device="cuda") -> Dict:
    """The PDHG stream end to end (``models/pdhg.solve_arrays_stream`` with
    ``crossover="unconverged"``: generation, staging, solve, exact
    recovery of the unconverged instances through K2): a cold pass, then
    the timed warm one; ``vs_baseline`` its wall over the device solve of
    one staged chunk (re-timed on CUDA events) times the chunks."""
    dev = torch_device(device)
    n_chunks = total // chunk

    def one_pass():
        t0 = time.perf_counter()
        converged = recovered = 0
        per_chunk = []
        for res in pdhg_mod.solve_arrays_stream(
                _chunks(n_chunks, chunk, m, n, 100), tol=TOL,
                max_iters=MAX_ITERS, maximize=True,
                crossover="unconverged", device=str(dev)):
            converged += int(np.sum(res.converged))
            recovered += 0 if res.exact is None else len(res.exact)
            per_chunk.append(res.solve_time)
        return time.perf_counter() - t0, converged, recovered, per_chunk

    cold_wall, _, _, _ = one_pass()
    wall, converged, recovered, per_chunk = one_pass()

    args = pdhg_inputs(chunk, m, n, 100, dev)

    def one():
        out = pdhg_mod._pdhg_solve(*args, max_iters=MAX_ITERS, tol=TOL)
        float(out[0].sum())

    one()
    device_s = rep_times(one, 1, dev)[0] * n_chunks
    return {
        "metric": f"stream_end_to_end_lps_per_sec_{total}",
        "value": total / wall,
        "unit": "LPs/s end-to-end (gen+stage+solve+recover)",
        "vs_baseline": wall / device_s,
        "detail": {
            "wall_s": wall,
            "cold_wall_s": cold_wall,
            "device_solve_s": device_s,
            "wall_over_device": wall / device_s,
            "chunks": n_chunks,
            "chunk_wall_s": per_chunk,
            "converged": converged,
            "exact_recovered": recovered,
            "converged_frac": converged / total,
            "device": device_name(dev),
        },
    }


def bench_stream_exact(total: int = 1_048_576, chunk: int = 65536,
                       m: int = 30, n: int = 50, device="cuda") -> Dict:
    """The exact certified sweep end to end (``models/batched.
    solve_arrays_stream``: every instance through the batched simplex, K2
    on a card, and every verdict f64-KKT-certified): one warm-up chunk,
    then one timed pass; ``vs_baseline`` the certified share."""
    dev = torch_device(device)
    n_chunks = total // chunk
    total = n_chunks * chunk
    cfg = SolverConfig(device=str(dev))

    def one_pass(batches):
        t0 = time.perf_counter()
        optimal = certified = escalated = 0
        solve_s = 0.0
        for res in solve_arrays_stream(batches, config=cfg, maximize=True):
            optimal += int(res.n_optimal)
            certified += int(np.sum(res.certified))
            escalated += int(res.n_escalated)
            solve_s += res.solve_time
        return (time.perf_counter() - t0, optimal, certified, escalated,
                solve_s)

    warmup = one_pass(_chunks(1, chunk, m, n, 300))[0]
    wall, optimal, certified, escalated, solve_s = one_pass(
        _chunks(n_chunks, chunk, m, n, 300))
    return {
        "metric": f"stream_exact_certified_lps_per_sec_{total}",
        "value": total / wall,
        "unit": "LPs/s end-to-end (gen+stage+solve+certify, f64-exact)",
        "vs_baseline": certified / total,
        "detail": {
            "wall_s": wall,
            "chunks": n_chunks,
            "chunk_size": chunk,
            "optimal": optimal,
            "certified": certified,
            "certified_frac": certified / total,
            "escalated": escalated,
            "device_solve_s_sum": solve_s,
            "engine": (f"batched simplex ({kernel_name('K2', dev)}) + "
                       "vectorized f64 KKT certification"),
            "warmup_s": warmup,
            "device": device_name(dev),
        },
    }
