"""Solve orchestration: problem dict → full report (port of
``simplex_tpu/controllers/orchestrator.py``; same report schema, solved by
the port's ``solve_lp`` on ``config.device``).

The JAX package's ``/metrics`` solve record (``utils/profiling``) is not
ported yet.  The original module's description follows.

Plays the role of the reference's ``SolverController``
(``app/controllers/solver_controller.py:53-120``): loads the
problem from the wrapper dict, solves it (here: the TPU two-phase tableau
simplex instead of scipy/HiGHS), generates the per-iteration tableau history
(device history kernel instead of simple_simplex) and the interactive
visualization (SVG widget instead of gilp), assembles + saves + returns the
report with the same schema:

    {"problema_definicion": {...},
     "solucion_encontrada": {"status", "mensaje_solver",
                             "valores_variables", "valor_optimo_z"},
     "visualizacion_gilp_html": "<...>",
     "tablas_intermedias": [...]}

Status strings: "Solucion Factible" / "Sin Solucion Factible" / "Error"
(``solver_controller.py:396-414``).
"""
from __future__ import annotations

import traceback
from typing import Dict, Optional

from ..config import SolverConfig, DEFAULT_CONFIG
from ..core.problem import LinearProgram, STATUS_INFEASIBLE
from ..models.dense import SimplexResult, solve_lp
from ..services import history as history_svc
from ..services import viz as viz_svc
from ..services.storage import StorageService

STATUS_FEASIBLE_STR = "Solucion Factible"
STATUS_INFEASIBLE_STR = "Sin Solucion Factible"
STATUS_ERROR_STR = "Error"


class SolverOrchestrator:
    """One solve request: problem wrapper dict in, report dict out."""

    def __init__(self, problem_data_wrapper: Dict,
                 config: SolverConfig = DEFAULT_CONFIG,
                 storage: Optional[StorageService] = None,
                 save: bool = True):
        if not problem_data_wrapper or \
                "problema_definicion" not in problem_data_wrapper:
            raise ValueError("Falta 'problema_definicion' en el problema.")
        self.problem = problem_data_wrapper["problema_definicion"]
        self.lp = LinearProgram.from_problem_dict(self.problem)
        self.config = config
        self.storage = storage or StorageService()
        self.save = save

    # ------------------------------------------------------------------ #
    def run(self) -> Optional[Dict]:
        """Solve + assemble + persist the report.  Returns None on abort."""
        if self.lp.n_vars == 0:
            return None
        result = solve_lp(self.lp, self.config)

        viz_html = ""
        tables = []
        if result.success:
            try:
                viz_html, tables = self._build_visualization(result)
            except Exception:
                traceback.print_exc()

        report = self._assemble_report(result, viz_html, tables)
        if self.save:
            self.storage.save_solution(report)
        return report

    # ------------------------------------------------------------------ #
    def _build_visualization(self, result: SimplexResult):
        hist = history_svc.compute_pivot_history(self.lp, self.config)
        tables = history_svc.history_to_tables(hist)
        path = history_svc.vertex_path_from_history(hist, self.lp.n_vars)
        viz_html = viz_svc.build_visualization_html(self.lp, tables, path)
        self._history_note = (
            f"Historial truncado a {hist['max_steps']} pasos."
            if hist.get("truncated") else None
        )
        if self._history_note:
            viz_html += (
                f'<p class="history-note">{self._history_note}</p>')
        return viz_html, tables

    def _assemble_report(self, result: SimplexResult, viz_html: str,
                         tables) -> Dict:
        if result.success:
            status = STATUS_FEASIBLE_STR
            valores = result.variable_values(self.lp.variables)
            valores = {k: round(v, 10) for k, v in valores.items()}
            z = result.z
        elif result.status == STATUS_INFEASIBLE:
            status, valores, z = STATUS_INFEASIBLE_STR, None, None
        else:
            status, valores, z = STATUS_ERROR_STR, None, None

        report = {
            "problema_definicion": self.problem,
            "solucion_encontrada": {
                "status": status,
                "mensaje_solver": result.message,
                "valores_variables": valores,
                "valor_optimo_z": z,
            },
            "visualizacion_gilp_html": viz_html,
            "tablas_intermedias": tables,
        }
        # History longer than the snapshot cap: say so instead of rendering
        # a silently-truncated table list (additive key, schema-compatible).
        note = getattr(self, "_history_note", None)
        if note:
            report["nota_historial"] = note
        # Additive section (absent from the reference's schema — HiGHS
        # computes marginals but solver_controller.py discards them):
        # shadow prices per constraint and reduced costs per variable,
        # USER-sense signs (see models/dense._sensitivity_on_host).
        if result.success and result.duals is not None:
            report["analisis_sensibilidad"] = {
                "precios_sombra": {
                    f"restriccion_{i+1}": round(float(d), 10) + 0.0
                    for i, d in enumerate(result.duals)
                },
                "costos_reducidos": {
                    v: round(float(r), 10) + 0.0
                    for v, r in zip(self.lp.variables, result.reduced_costs)
                },
            }
        return report


def solve_problem_dict(problem_data_wrapper: Dict,
                       config: SolverConfig = DEFAULT_CONFIG,
                       save: bool = True) -> Optional[Dict]:
    """Function-style entry: wrapper dict → report dict."""
    return SolverOrchestrator(problem_data_wrapper, config,
                              save=save).run()
