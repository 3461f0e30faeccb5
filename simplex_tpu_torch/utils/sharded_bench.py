"""The row-sharded loop's per-pivot cost (port of ``bench.py::bench_sharded``).

:func:`bench_sharded` times ``parallel/sharded.solve_tableau_sharded`` on a
1x1 mesh, where every collective runs through a one-rank group (NCCL on
the card once ``parallel.distributed.initialize`` built one, the identity
without a group), and holds it against the single-LP pivot
``ops/tableau.pivot_update`` (kernel K1 on the card) chained at a matched
row count.  Times are CUDA events on the card (``utils/pivot_bench``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import torch_device
from ..ops.tableau import pivot_update
from ..parallel.sharded import (compile_sharded, make_mesh,
                                solve_tableau_sharded, stage_shards)
from .pivot_bench import (chain_time, device_name, median_time,
                          pivot_problem)


def sharded_problem(m: int, device):
    """``bench_sharded``'s LP (seed 7, m x m, every row tight, so it pivots
    on and on) as ``solve_tableau_sharded``'s float32 arguments on
    ``device`` for a 1x1 mesh."""
    rng = np.random.default_rng(7)
    A = rng.uniform(0.05, 1.0, size=(1, m, m)).astype(np.float32)
    x0 = rng.uniform(0.5, 1.5, size=m).astype(np.float32)
    b = (A[0] @ x0)[None, :]
    c = rng.uniform(0.1, 1.0, size=(1, m)).astype(np.float32)
    _, arrays, _ = compile_sharded(c, A, b, np.full((m,), -1), True)
    return stage_shards(arrays, make_mesh(), device)


def bench_sharded(size: int = 10240, iters: int = 64, reps: int = 3,
                  compare_size: int = 8192, device="cuda") -> Dict:
    """Per-pivot cost of the sharded loop on a 1x1 mesh.

    Three figures, medians of ``reps`` solves after a warm one, as
    ``bench.py`` takes them:
      * per-pivot ms and effective GB/s at ``size`` rows (m = n = size, so
        an (m, 2m + 1) row block) with no resync in the window, and the
        same with a resync every 64 steps;
      * ``vs_baseline``: the sharded loop's effective GB/s at
        ``compare_size`` over ``pivot_update`` chained ``iters`` times on
        a (compare_size + 1)^2 tableau (K1 on the card).
    Effective GB/s counts two passes over the row block a pivot (the
    rank-1 update's read and write).  ``device`` is the card by default
    (it raises where there is none); the CPU runs only in tests.
    """
    dev = torch_device(device)
    mesh = make_mesh(batch=1, row=1)

    problems = {}

    def run_one(m, refactor_every):
        if m not in problems:
            problems.clear()
            problems[m] = sharded_problem(m, dev)
        args = problems[m]

        def one():
            out = solve_tableau_sharded(
                *args, mesh=mesh, max_iters=iters,
                refactor_every=refactor_every, devex=True)
            float(out[2].sum())
            return out[4]

        it0 = one()                            # warm
        dt, spread = median_time(one, reps, dev)
        dt /= max(it0, 1)
        m_pad, n1 = args[0].shape[1:]
        tbytes = m_pad * n1 * 4
        return {
            "per_pivot_ms": dt * 1e3,
            "effective_GBps": 2.0 * tbytes / dt / 1e9,
            "tableau_MB": tbytes / 1e6,
            "iters": it0,
            "spread": spread,
        }

    steady = run_one(size, refactor_every=iters + 1)
    with_resync = run_one(size, refactor_every=64)
    cmp_sharded = run_one(compare_size, refactor_every=iters + 1)
    problems.clear()

    # The single-LP pivot at the matched row count.
    T_np, rs_np = pivot_problem(compare_size, iters)
    T0 = torch.from_numpy(T_np).to(dev)
    basis0 = torch.arange(compare_size, dtype=torch.int64, device=dev)
    rs = torch.from_numpy(rs_np).to(dev)
    T, basis = T0.clone(), basis0.clone()

    def reset():
        T.copy_(T0)
        basis.copy_(basis0)

    def step(k):
        pivot_update(T, basis, rs[k, 0], rs[k, 1])
        return T

    dt_single, single_spread = chain_time(step, iters, reps, dev, reset)
    single_gbps = 2.0 * (compare_size + 1) ** 2 * 4 / dt_single / 1e9
    return {
        "metric": f"sharded_pivots_per_sec_{size}x{size}_f32",
        "value": 1e3 / steady["per_pivot_ms"],
        "unit": "pivots/s/chip ((1,1) mesh)",
        "vs_baseline": cmp_sharded["effective_GBps"] / single_gbps,
        "detail": {
            "steady": steady,
            "with_resync_every_64": with_resync,
            "compare_at": compare_size,
            "sharded_cmp_GBps": cmp_sharded["effective_GBps"],
            "sharded_cmp_per_pivot_ms": cmp_sharded["per_pivot_ms"],
            "sharded_cmp_iters": cmp_sharded["iters"],
            "single_kernel_GBps": single_gbps,
            "single_kernel_per_pivot_ms": dt_single * 1e3,
            "single_kernel_spread": single_spread,
            "n_reps": reps,
            "device": device_name(dev),
        },
    }
