"""The multidimensional knapsack entry: ``BatchedSimplexSolver.solve_arrays``
on the LP relaxations that ``traffic/mknap.py`` draws (every row ``<=``,
``ub=`` on every variable, so kernel K3 takes every step), one call a
batch, with the configuration's ``SolverConfig`` (certification on).

The call is ``entries/solve_arrays.py``'s.  Traced span: ``run`` around
``models/batched.py::_run_batch``, whose note also keeps each instance's
bound flips (``flips`` of the loop's result), for ``k3_roofline.mknap``.

The run is the harness's (``harness.run``) with this traffic's generator
and the bounded reference (``reference/bounded.py``) in place of
``traffic/generate.py`` and ``reference/simplex.py``.  The same swap lets
``lpbench.calibrate`` read the cell's limits:

    python3 -m lpbench.entries.mknap_relax --workload mknapcb9.relax \\
        --seeds 1,2 --control-seeds 7,8,9
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np

from lpbench.entries import solve_arrays

LABEL = "batch"


def _note_run(rec, args, kwargs, res):
    solve_arrays._note_run(rec, args, kwargs, res)
    flips = getattr(res, "flips", None)
    if flips is not None:
        rec["notes"]["flips"] = np.asarray(flips)


class Entry(solve_arrays.Entry):
    def __init__(self, device, cell):
        super().__init__(device, cell)
        self.spans = [("simplex_tpu_torch.models.batched", "_run_batch",
                       "run", _note_run)]


def make(device, cell):
    return Entry(device, cell)


@contextlib.contextmanager
def sources():
    """The harness and the calibration draw inputs from
    ``traffic/mknap.py`` and judge them by ``reference/bounded.py``."""
    from lpbench import calibrate, harness
    from lpbench.reference import bounded
    from lpbench.traffic import mknap

    swaps = [(mod, name, new) for mod in (harness, calibrate)
             for name, new in (("generate", mknap), ("simplex", bounded))]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, new in swaps:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in kept:
            setattr(mod, name, old)


def run(args, cell, t_proc, entry_mod) -> int:
    from lpbench import harness

    with sources():
        return harness.run(args, cell, t_proc, entry_mod)


if __name__ == "__main__":
    from lpbench import calibrate

    with sources():
        sys.exit(calibrate.main())
