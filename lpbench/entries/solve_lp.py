"""The single-LP entry: ``models/dense.py::solve_lp`` with the
configuration's ``SolverConfig``, one ``LinearProgram`` a call (the path of
the CLI, the web report and every solve of one LP).

Traced span: ``loop`` around ``ops/tableau.py::solve_tableau`` (the
graphed device loop, to its last host read); it notes the tableau's shape
and the pivots it made, for K1's roofline.  The rest of a call is the
host's: equilibration, presolve, the standard form, the float64 finalize
and certificate.
"""
from __future__ import annotations

import numpy as np

LABEL = "dense"


def _note_loop(rec, args, kwargs, out):
    T0 = kwargs.get("T0", args[0] if args else None)
    R, W = T0.shape
    notes = rec["notes"]
    notes["tableau"] = (int(R), int(W), int(T0.element_size()))
    notes["pivots"] = notes.get("pivots", 0) + int(out[3])


class Entry:
    def __init__(self, device, cell):
        from simplex_tpu_torch.config import SolverConfig

        self.config = SolverConfig(device=device, **cell["config"]["solver"])
        self.spans = [("simplex_tpu_torch.ops.tableau", "solve_tableau",
                       "loop", _note_loop)]

    def call(self, item):
        from simplex_tpu_torch.core.problem import LinearProgram
        from simplex_tpu_torch.models.dense import solve_lp

        m = item["A"].shape[1]
        lp = LinearProgram(c=item["c"][0], A=item["A"][0], b=item["b"][0],
                           ops=np.full(m, -1), maximize=True)
        r = solve_lp(lp, self.config)
        n = item["c"].shape[1]

        def row(v, k):
            return (np.full((1, k), np.nan) if v is None
                    else np.asarray(v, float)[None])

        return {"status": np.array([r.status]), "x": row(r.x, n),
                "z": np.array([np.nan if r.z is None else r.z]),
                "escalated": np.array([bool(r.escalated)]),
                "y": row(r.duals, m), "rc": row(r.reduced_costs, n)}

    def release(self):
        from simplex_tpu_torch.runtime import graphs

        graphs.clear()


def make(device, cell):
    return Entry(device, cell)
