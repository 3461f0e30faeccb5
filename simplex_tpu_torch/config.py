"""Typed configuration for the PyTorch / CUDA port.

Mirrors ``simplex_tpu/config.py``: the same ``SolverConfig`` fields and
defaults, the same output directory and file prefixes (the storage service
reads them), plus ``device``.  The solver places every tensor on
``config.device`` and casts every input to ``config.dtype`` explicitly
(``torch.as_tensor`` would keep a float64 array as float64, while the
reference runs float32).  ``device="cuda"`` is the default and raises where
no GPU is present; CPU runs pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

BASE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# Artifact directory (same variable and default as the JAX package).
OUTPUT_DIR = os.environ.get(
    "SIMPLEX_TPU_OUTPUT_DIR", os.path.join(BASE_DIR, "outputs")
)

# Sequential-file prefixes, identical to the JAX package so that artifacts
# written by either package load in the other.
PREFIX_FUNCION_OBJETIVO = "funcion_objetivo"
PREFIX_RESTRICCIONES = "restricciones"
PREFIX_SOLUCION = "solucion_"
PREFIX_PROBLEMA = "problema_"
PREFIX_PDF = "reporte_solucion_"


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Options for the port's simplex engine (see ``simplex_tpu/config.py``
    for the meaning of each shared field)."""

    pivot_rule: str = "devex"
    bland_after: int = 256
    presolve: bool = True
    tol: float = 1e-6
    max_iters: int = 16384
    dtype: str = "float32"
    refine: bool = True
    certify: bool = True
    time_limit: Optional[float] = 10.0
    max_history: int = 64
    # Exact-refactorization period; None = auto: max(64, m_pad // 8).  It is
    # also the length of one device chunk between host reads of the loop
    # state (ops/tableau.py::_run_phase).
    refactor_every: Optional[int] = None
    batched_backend: str = "auto"
    # Torch device of the solve: "cuda" (the pivot runs through the
    # hand-written kernel) or "cpu" (the kernel's plain PyTorch twin).
    device: str = "cuda"

    @staticmethod
    def from_env() -> "SolverConfig":
        """Build a config from ``SIMPLEX_TPU_*`` env vars; an empty
        environment gives exactly ``SolverConfig()``."""
        d = SolverConfig()

        def _env_bool(name: str, default: bool) -> bool:
            v = os.environ.get(name)
            if not v:
                return default
            return v.strip().lower() in ("1", "true", "yes", "on")

        time_limit_s = os.environ.get("SIMPLEX_TPU_TIME_LIMIT")
        refactor_s = os.environ.get("SIMPLEX_TPU_REFACTOR_EVERY")
        return SolverConfig(
            pivot_rule=os.environ.get("SIMPLEX_TPU_PIVOT_RULE", d.pivot_rule),
            bland_after=_env_int("SIMPLEX_TPU_BLAND_AFTER", d.bland_after),
            presolve=_env_bool("SIMPLEX_TPU_PRESOLVE", d.presolve),
            tol=_env_float("SIMPLEX_TPU_TOL", d.tol),
            max_iters=_env_int("SIMPLEX_TPU_MAX_ITERS", d.max_iters),
            dtype=os.environ.get("SIMPLEX_TPU_DTYPE", d.dtype),
            refine=_env_bool("SIMPLEX_TPU_REFINE", d.refine),
            certify=_env_bool("SIMPLEX_TPU_CERTIFY", d.certify),
            time_limit=(float(time_limit_s) if time_limit_s
                        else d.time_limit),
            max_history=_env_int("SIMPLEX_TPU_MAX_HISTORY", d.max_history),
            refactor_every=(int(refactor_s) if refactor_s
                            else d.refactor_every),
            batched_backend=os.environ.get("SIMPLEX_TPU_BATCHED_BACKEND",
                                           d.batched_backend),
            device=os.environ.get("SIMPLEX_TPU_DEVICE", d.device),
        )


DEFAULT_CONFIG = SolverConfig()


def resolve_dtype(dtype_str: str):
    """``(numpy dtype, torch dtype)`` for a config dtype string."""
    import torch

    dt = np.dtype(dtype_str)
    torch_dt = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}.get(dt)
    if torch_dt is None:
        raise ValueError(f"unsupported solver dtype {dtype_str!r}")
    return dt, torch_dt
