# Copied from simplex_tpu/controllers/cli_io.py; keep in step (tests/test_torch_core.py).
"""Interactive CLI input controllers (objective + constraints).

Behavioral parity with the reference's CLI controllers
(``app/controllers/objective_function_controller.py:18-93``
and ``constraints_controller.py:17-114``): retry loops on parse errors,
``fin`` terminates constraint entry, explicit non-negativity constraints are
rejected, constraint variables must be a subset of the objective's, missing
variables are zero-filled, and artifacts are saved through the storage
service.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

from ..core.parsing import (
    Constraint,
    ConstraintsParser,
    ConstraintsValidator,
    ObjectiveFunctionParser,
)
from ..services.storage import StorageService

_NONNEG_RE = re.compile(r"^\s*x\d+\s*>=\s*0\s*$")


class ObjectiveFunctionController:
    """Prompt loop: max/min choice, then the objective expression."""

    def __init__(self, storage: Optional[StorageService] = None,
                 input_fn: Callable[[str], str] = input,
                 print_fn: Callable[[str], None] = print):
        self.storage = storage or StorageService()
        self._input = input_fn
        self._print = print_fn

    def run(self) -> Optional[Dict]:
        self._print("=== Función objetivo ===")
        while True:
            kind = self._input(
                "¿Maximizar o minimizar? [max/min]: ").strip().lower()
            if kind in ("max", "maximize", "maximizar"):
                obj_type = "maximize"
                break
            if kind in ("min", "minimize", "minimizar"):
                obj_type = "minimize"
                break
            self._print("Opción inválida. Escriba 'max' o 'min'.")

        while True:
            expr = self._input(
                "Ingrese la función objetivo (ej: Z = 3x1 - 5x2): ")
            try:
                coefficients = ObjectiveFunctionParser.parse(expr)
                break
            except ValueError as e:
                self._print(f"Error: {e}")

        data = {"type": obj_type, "coefficients": coefficients}
        self.storage.save_objective(data)
        self._print(f"Función objetivo registrada: {data}")
        return data


class ConstraintsController:
    """Prompt loop until 'fin'; validates each constraint against the
    objective's variable set."""

    def __init__(self, storage: Optional[StorageService] = None,
                 input_fn: Callable[[str], str] = input,
                 print_fn: Callable[[str], None] = print):
        self.storage = storage or StorageService()
        self._input = input_fn
        self._print = print_fn

    def run(self, expected_vars: List[str]) -> Optional[List[Constraint]]:
        self._print("=== Restricciones (escriba 'fin' para terminar) ===")
        expected = set(expected_vars)
        constraints: List[Constraint] = []
        while True:
            expr = self._input(f"Restricción {len(constraints) + 1}: ")
            if expr.strip().lower() == "fin":
                break
            if _NONNEG_RE.match(expr):
                self._print("La no-negatividad (x_i >= 0) es implícita; "
                            "no es necesario ingresarla.")
                continue
            try:
                con = ConstraintsParser.parse(expr)
            except ValueError as e:
                self._print(f"Error: {e}")
                continue

            unknown = set(con.coefficients) - expected
            if unknown:
                self._print(
                    f"Error: variables desconocidas {sorted(unknown)}; "
                    f"la función objetivo usa {sorted(expected)}.")
                continue
            # Zero-fill variables the constraint does not mention.
            for v in expected:
                con.coefficients.setdefault(v, 0.0)
            constraints.append(con)

        if not constraints:
            self._print("No se ingresaron restricciones.")
            return None
        try:
            ConstraintsValidator.validate_set_consistency(constraints)
        except ValueError as e:
            self._print(f"Error de consistencia: {e}")
            return None
        self.storage.save_constraints([c.to_dict() for c in constraints])
        self._print(f"{len(constraints)} restricciones registradas.")
        return constraints
