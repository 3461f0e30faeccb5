"""Per-iteration tableau history -> report tables (``tablas_intermedias``).

Port of ``simplex_tpu/services/history.py``: :func:`compute_pivot_history`
runs the port's ``ops/tableau.py::solve_tableau_history`` on
``config.device``; :func:`history_to_tables` and
:func:`vertex_path_from_history` are copied as they are (numpy only).  Each
table entry is

    {"iteration": k,
     "title": "Iteración 0 (Tabla Inicial)" | "Iteración k (Pivote: Fila r, Col c)",
     "table": [[headers...], ["F0", cells...], ...],   # 4-dp rounded floats
     "pivot": (row, col) | None}
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SolverConfig, DEFAULT_CONFIG
from ..core.problem import (STATUS_ITERATION_LIMIT, LinearProgram,
                            compile_standard_form, lower_bounds_to_rows,
                            split_free_variables)
from ..ops import tableau as tableau_ops


def compute_pivot_history(lp: LinearProgram,
                          config: SolverConfig = DEFAULT_CONFIG,
                          max_steps: Optional[int] = None) -> Dict:
    """Run the history-capturing solve; returns dict with raw snapshots.

    A presentation feature for small problems: finite bounds display as
    bound rows, free variables through their x = x+ - x- split columns, and
    the snapshots are cropped to the real rows and columns.  The pricing and
    the phase-1 threshold are the production solve's, so the recorded pivot
    sequence is the path the reported solve took.
    """
    lp = split_free_variables(lower_bounds_to_rows(lp))[0]
    sf = compile_standard_form(lp)
    steps = int(max_steps or config.max_history)
    # float32 whatever config.dtype says, like the JAX package (the
    # standard form compiles in float32 by default).
    state = tableau_ops.state_from_standard_form(
        sf, torch.device(config.device), torch.float32)
    T, basis, status, snaps, pivots, valid = tableau_ops.solve_tableau_history(
        state["T0"], state["basis0"], state["col_mask_p1"],
        state["col_mask_p2"], state["obj_row_p2"],
        need_phase1=sf.need_phase1,
        tol=max(config.tol, 1e-6),
        max_steps=steps,
        bland_after=int(config.bland_after),
        devex=config.pivot_rule == "devex",
    )
    snaps = snaps.cpu().numpy()
    pivots = pivots.numpy()
    valid = valid.numpy()
    T = T.cpu().numpy()

    m, nc, npad = sf.n_rows, sf.n_cols, sf.n_pad
    live = [k for k in range(snaps.shape[0]) if valid[k]]

    # Crop each snapshot to [real constraint rows + objective row] x
    # [real columns + RHS].
    def crop(Tk):
        rows = np.concatenate([Tk[:m], Tk[-1:]], axis=0)
        return np.concatenate([rows[:, :nc], rows[:, npad:npad + 1]], axis=1)

    entries = []
    # Step 0: the initial tableau, pivot indices None.
    entries.append({"step": 0, "tableau": crop(snaps[0] if len(snaps) else
                                               np.asarray(sf.tableau)),
                    "pivot": None})
    for i, k in enumerate(live):
        r, s = int(pivots[k, 0]), int(pivots[k, 1])
        nxt = snaps[k + 1] if k + 1 < snaps.shape[0] else T
        entries.append({"step": i + 1, "tableau": crop(nxt),
                        "pivot": (r if r < m else m, s if s < nc else nc)})
        # entry i's tableau is the state AFTER pivot i, while the pivot
        # recorded is the one APPLIED to the previous state.

    return {
        "status": int(status),
        # The step cap was hit before a verdict: the displayed tables are a
        # silent prefix of the real pivot sequence unless flagged.
        "truncated": int(status) == STATUS_ITERATION_LIMIT,
        "max_steps": steps,
        "entries": entries,
        "n_rows": m,
        "n_cols": nc,
        "final_tableau": crop(T),
    }


def history_to_tables(history: Dict) -> List[Dict]:
    """Convert raw history entries into the report's table schema."""
    out = []
    for e in history["entries"]:
        step = e["step"]
        pivot = e["pivot"]
        tab = e["tableau"]
        num_cols = tab.shape[1]
        headers = ["Base"] + [f"C{i}" for i in range(num_cols)]
        if step == 0 or pivot is None:
            title = "Iteración 0 (Tabla Inicial)"
        else:
            title = f"Iteración {step} (Pivote: Fila {pivot[0]}, Col {pivot[1]})"
        rows = [headers]
        for i in range(tab.shape[0]):
            rows.append([f"F{i}"] + [round(float(v), 4) for v in tab[i]])
        out.append({
            "iteration": step,
            "title": title,
            "table": rows,
            "pivot": tuple(pivot) if pivot is not None else None,
        })
    return out


def vertex_path_from_history(history: Dict, n_vars: int) -> List[List[float]]:
    """Decision-variable values at each recorded iteration (for the 2-D
    geometric widget's vertex path).

    A decision variable is basic in a snapshot iff its column is a unit
    vector; its value is then that row's RHS.
    """
    path = []
    for e in history["entries"]:
        tab = e["tableau"]          # (m+1, nc+1) cropped
        rows, rhs = tab[:-1, :], tab[:-1, -1]
        x = []
        for j in range(min(n_vars, tab.shape[1] - 1)):
            col = rows[:, j]
            ones = np.isclose(col, 1.0, atol=1e-5)
            if ones.sum() == 1 and np.allclose(col[~ones], 0.0, atol=1e-5):
                x.append(float(rhs[np.argmax(ones)]))
            else:
                x.append(0.0)
        path.append([max(v, 0.0) for v in x])
    return path
