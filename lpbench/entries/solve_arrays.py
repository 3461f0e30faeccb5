"""The batched entry: ``BatchedSimplexSolver.solve_arrays`` with the
configuration's ``SolverConfig`` (certification on), one call a batch of
the traffic, ``ub=`` where the traffic bounds its variables.

Traced spans: ``run`` around ``models/batched.py::_run_batch`` (device
assembly of the tableau to the loop's host read and the extraction) and
``certify`` around ``certify_uniform_result`` (the float64 KKT check and
any escalation on the host).  ``_run_batch`` also notes the tableau's
shape, the instances' pivot counts and the loop's iterations (one K2 or K3 launch each),
for the kernels' rooflines.
"""
from __future__ import annotations

import numpy as np

LABEL = "batch"


def _note_run(rec, args, kwargs, res):
    cb = args[0]
    B, M, N = cb.T0.shape
    rec["notes"]["tableau"] = (int(B), int(M), int(N),
                               int(cb.T0.dtype.itemsize))
    rec["notes"]["pivots"] = np.asarray(res.pivots)
    rec["notes"]["bounded"] = cb.ub_ext is not None
    # One K2 or K3 launch an iteration of the loop (the graphed loop stops
    # at the verdict).
    rec["notes"]["launches"] = int(res.nit)


class Entry:
    def __init__(self, device, cell):
        from simplex_tpu_torch.config import SolverConfig
        from simplex_tpu_torch.models.batched import BatchedSimplexSolver

        cfg = cell["config"]["solver"]
        self.solver = BatchedSimplexSolver(SolverConfig(device=device,
                                                        **cfg))
        self.spans = [
            ("simplex_tpu_torch.models.batched", "_run_batch", "run",
             _note_run),
            ("simplex_tpu_torch.models.batched", "certify_uniform_result",
             "certify", None)]

    def call(self, item):
        m, n = item["A"].shape[1:]
        res = self.solver.solve_arrays(item["c"], item["A"], item["b"],
                                       np.full(m, -1), maximize=True,
                                       ub=item["ub"])
        return {"status": np.asarray(res.status), "x": res.x, "z": res.z,
                "certified": res.certified, "escalated": res.escalated,
                "at_upper": (None if res.at_upper is None
                             else res.at_upper[:, :n])}

    def release(self):
        from simplex_tpu_torch.runtime import graphs

        graphs.clear()
        self.solver = None


def make(device, cell):
    return Entry(device, cell)
