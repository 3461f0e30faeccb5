#!/usr/bin/env python3
"""Where the revised engine stops reaching its optimum on the card.

    python3 tools/revised_sizes.py [2000x6000 1000x3000 500x1500 ...]

Solves ``utils/mps.generate_netlib_style(1, m, n, density=0.03)`` (the LP
of ``chip_smoke.py`` phase 14 (b)) with ``RevisedSimplexSolver`` on the
card at each size given (``MxN``; by default netlib's large-instance scale
and its halvings) and prints, for each, either the verdict the device loop
reached (status, pivots, wall seconds, pivots/s, host reads of the loop
state) or that the solve would escalate to the host's float64 engine, with
the seconds and the loop iterations until then.  The host engine itself is
not run: on a dense 2000 x 8000 tableau it would take many minutes.  The
card's name and power limit come first.  Needs a CUDA card; imports
nothing of JAX.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Escalation(Exception):
    """Raised where the solve would hand the LP to the host engine."""


def _escalate(*args, **kwargs):
    raise Escalation()


def main(argv):
    import torch

    import simplex_tpu_torch as pt
    from simplex_tpu_torch.models import revised
    from simplex_tpu_torch.utils.mps import generate_netlib_style

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    sizes = [tuple(int(v) for v in a.split("x"))
             for a in (argv or ["2000x6000", "1000x3000", "500x1500"])]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    revised._host_simplex_f64 = _escalate
    revised.RevisedSimplexSolver._escalate_bounded = _escalate
    solver = pt.RevisedSimplexSolver(pt.SolverConfig(device="cuda"))
    solver.solve(generate_netlib_style(1, m=200, n=600, density=0.03))
    for m, n in sizes:
        lp = generate_netlib_style(1, m=m, n=n, density=0.03)
        revised.STATE_READS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = solver.solve(lp)
        except Escalation:
            print(f"{m}x{n}: escalates to the host after "
                  f"{time.perf_counter() - t0!r} s and "
                  f"{revised.STATE_READS} chunks (up to "
                  f"{64 * revised.STATE_READS} loop iterations)", flush=True)
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{m}x{n}: status {res.status}, {res.nit} pivots, z={res.z!r}, "
              f"wall {wall!r} s, {res.nit / wall!r} pivots/s, "
              f"{revised.STATE_READS} host reads of the loop state",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
