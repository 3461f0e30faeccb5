"""Command-line interface of the PyTorch / CUDA port.

    python -m simplex_tpu_torch.cli solve problem.json [--device cuda|cpu]
    python -m simplex_tpu_torch.cli solve-latest [--device cuda|cpu]

The report path of ``simplex_tpu/cli.py`` (same JSON problem files, same
output directory, same printed report) solved by the port.  ``--device``
defaults to ``cuda``.  MPS files, ``interactive``, ``serve`` and
``export-pdf`` are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from .config import SolverConfig
from .controllers.orchestrator import solve_problem_dict
from .core.problem import validate_problem_structure
from .services.storage import StorageService


def _print_report(report: Dict):
    sol = report["solucion_encontrada"]
    print("\n=== Resultado ===")
    print(f"Estado: {sol['status']}")
    print(f"Mensaje: {sol['mensaje_solver']}")
    if sol["status"] == "Solucion Factible":
        for var, val in sol["valores_variables"].items():
            print(f"  {var} = {val:.4f}")
        print(f"  Z = {sol['valor_optimo_z']:.4f}")
    sens = report.get("analisis_sensibilidad")
    if sens:
        print("\n--- Análisis de sensibilidad ---")
        for con, val in sens["precios_sombra"].items():
            print(f"  {con}: precio sombra = {val:.4f}")
        for var, val in sens["costos_reducidos"].items():
            print(f"  {var}: costo reducido = {val:.4f}")


def _solve_wrapper(wrapper: Dict, config: SolverConfig) -> int:
    problem = wrapper.get("problema_definicion")
    if not problem:
        print("El archivo no contiene 'problema_definicion'.")
        return 1
    ok, msg = validate_problem_structure(problem)
    if not ok:
        print(f"Problema inválido: {msg}")
        return 1
    report = solve_problem_dict(wrapper, config)
    if report is None:
        print("Error durante la resolución.")
        return 1
    _print_report(report)
    return 0


def cmd_solve(args) -> int:
    try:
        with open(args.file, "r", encoding="utf-8") as f:
            wrapper = json.load(f)
    except (IOError, json.JSONDecodeError) as e:
        print(f"No se pudo leer {args.file}: {e}")
        return 1
    return _solve_wrapper(wrapper, SolverConfig(device=args.device))


def cmd_solve_latest(args) -> int:
    wrapper = StorageService().load_problem()
    if wrapper is None:
        print("No hay problemas guardados.")
        return 1
    return _solve_wrapper(wrapper, SolverConfig(device=args.device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="simplex_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    p_solve = sub.add_parser("solve", help="resolver un problema JSON")
    p_solve.add_argument("file")
    p_latest = sub.add_parser("solve-latest",
                              help="resolver el último problema guardado")
    for p in (p_solve, p_latest):
        p.add_argument("--device", default="cuda",
                       help="dispositivo torch del solve (cuda o cpu)")

    args = parser.parse_args(argv)
    commands = {"solve": cmd_solve, "solve-latest": cmd_solve_latest}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
