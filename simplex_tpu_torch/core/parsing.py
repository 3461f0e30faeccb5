# Copied from simplex_tpu/core/parsing.py; keep in step (tests/test_torch_core.py).
"""Expression parsing for objective functions and constraints.

Behavioral parity with the reference grammar
(``app/core/objective_function.py`` and
``app/core/constraints.py``), re-implemented token-first:

* objective:  ``"Z = 3x1 - 5x2 + 0x3"`` → ``{"x1": 3.0, "x2": -5.0, "x3": 0.0}``
  — objective terms REQUIRE an explicit numeric coefficient (the reference
  regex ``([+-]?\\d+\\.?\\d*)\\*?x(\\d+)`` rejects a bare ``x1``).
* constraint: ``"2x1 - 3x2 <= 10"`` → ``Constraint``; operators ``<=``, ``>=``,
  ``=``; implicit ±1 coefficients allowed; ``*`` between coefficient and
  variable allowed; duplicate variables and unparsed garbage rejected.

Deliberate fix vs the reference (SURVEY.md §7): variables are ordered
NUMERICALLY everywhere (x2 before x10), not lexicographically
(reference bug at ``solver_controller.py:46``).
"""
from __future__ import annotations

import re
from typing import Dict, List

_OBJ_TERM = re.compile(r"([+-]?\d+\.?\d*)\*?x(\d+)")
_CON_TERM = re.compile(r"([+-]?\d*\.?\d*)\*?x(\d+)")

VALID_OPERATORS = ("<=", ">=", "=")


def variable_order(names) -> List[str]:
    """Sort variable names numerically: x1, x2, ..., x10 (not x1, x10, x2)."""
    return sorted(names, key=lambda v: int(v[1:]))


def _check_consecutive(coefficients: Dict[str, float], what: str = "Las variables"):
    indices = sorted(int(v[1:]) for v in coefficients.keys())
    if not indices or indices[0] != 1:
        raise ValueError(f"{what} deben comenzar en x1.")
    for prev, cur in zip(indices, indices[1:]):
        if cur != prev + 1:
            raise ValueError(
                f"Falta la variable x{prev + 1}. {what} deben ser consecutivas (ej: x1, x2, x3)."
            )


class ObjectiveFunctionParser:
    """Parses ``Z = 3x1 - 5x2`` style objective expressions."""

    @staticmethod
    def parse(expression: str) -> Dict[str, float]:
        if not expression or not expression.strip():
            raise ValueError("La función objetivo no puede estar vacía.")

        text = expression.replace(" ", "")
        # Strip an optional "Z =" prefix; keep the right-hand side.
        if "=" in text:
            text = text.split("=", 1)[1] or text.split("=", 1)[0]

        terms = _OBJ_TERM.findall(text)
        if not terms:
            raise ValueError("Formato inválido. Ejemplo válido: Z = -2x1 + 3x2 + 0x3")

        coefficients: Dict[str, float] = {}
        for coef_str, idx in terms:
            try:
                coefficients[f"x{idx}"] = float(coef_str)
            except ValueError:
                raise ValueError(f"Coeficiente inválido: {coef_str}")

        _check_consecutive(coefficients)
        return coefficients


class Constraint:
    """A single linear constraint: coefficients, relational operator, rhs."""

    __slots__ = ("coefficients", "operator", "rhs")

    def __init__(self, coefficients: Dict[str, float], operator: str, rhs: float):
        self.coefficients = coefficients
        self.operator = operator
        self.rhs = rhs

    def to_dict(self) -> Dict:
        return {
            "coefficients": self.coefficients,
            "operator": self.operator,
            "rhs": self.rhs,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "Constraint":
        return cls(
            coefficients=dict(data.get("coefficients", {})),
            operator=data.get("operator", "="),
            rhs=data.get("rhs", 0.0),
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        lhs = " + ".join(f"{c}{v}" for v, c in self.coefficients.items())
        return f"Constraint({lhs} {self.operator} {self.rhs})"


class ConstraintsParser:
    """Parses ``"2x1 - 3x2 <= 10"`` style constraint expressions."""

    VALID_OPERATORS = list(VALID_OPERATORS)

    @staticmethod
    def parse(expression: str) -> Constraint:
        if not expression or not expression.strip():
            raise ValueError("La restricción no puede estar vacía.")

        text = expression.replace(" ", "")

        operator = None
        for op in VALID_OPERATORS:  # "<=" and ">=" checked before "="
            if op in text:
                sides = text.split(op)
                if len(sides) == 2:
                    operator = op
                    left, right = sides
                    break
        if operator is None:
            raise ValueError(
                "Formato inválido. Debe contener un operador válido: "
                + ", ".join(VALID_OPERATORS)
            )

        try:
            rhs = float(right)
        except ValueError:
            raise ValueError(
                f"El lado derecho (RHS) debe ser un número válido. Se recibió: '{right}'"
            )

        coefficients = ConstraintsParser._parse_left_side(left)
        return Constraint(coefficients, operator, rhs)

    @staticmethod
    def _parse_left_side(left: str) -> Dict[str, float]:
        if not left:
            raise ValueError("El lado izquierdo de la restricción está vacío.")
        if left[0] not in "+-":
            left = "+" + left

        matches = _CON_TERM.findall(left)
        if not matches:
            raise ValueError(
                "Formato inválido en el lado izquierdo. Ejemplo válido: 2x1 + 3x2"
            )

        # Full-coverage check: reassembling the matched terms must reproduce
        # the input exactly, otherwise unrecognized garbage is present.
        rebuilt = "".join(f"{c}x{i}" for c, i in matches)
        if rebuilt != left.replace("*", ""):
            raise ValueError("Formato inválido. Contiene términos no reconocidos.")

        coefficients: Dict[str, float] = {}
        for coef_str, idx in matches:
            name = f"x{idx}"
            if name in coefficients:
                raise ValueError(f"Variable duplicada: {name}")
            if coef_str in ("+", ""):
                value = 1.0
            elif coef_str == "-":
                value = -1.0
            else:
                try:
                    value = float(coef_str)
                except ValueError:
                    raise ValueError(f"Coeficiente inválido: '{coef_str}'")
            coefficients[name] = value
        return coefficients


class ConstraintsValidator:
    """Business-rule validation over parsed constraints."""

    @staticmethod
    def validate_consecutive_variables(coefficients: Dict[str, float]):
        if not coefficients:
            return
        _check_consecutive(coefficients, what="La numeración de variables")

    @staticmethod
    def validate_set_consistency(constraints: List[Constraint]) -> bool:
        """All constraints must mention the same variable set (after 0-fill)."""
        if not constraints:
            return True
        expected = set(constraints[0].coefficients.keys())
        for i, con in enumerate(constraints[1:], start=1):
            got = set(con.coefficients.keys())
            if got != expected:
                raise ValueError(
                    f"Inconsistencia de variables en la restricción {i + 1}. "
                    f"Se esperaban {sorted(expected)} pero se encontraron {sorted(got)}."
                )
        return True
