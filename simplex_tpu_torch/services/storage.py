# Copied from simplex_tpu/services/storage.py; keep in step (tests/test_torch_core.py).
"""Artifact persistence: numbered JSON/PDF files with latest-wins loading.

Behavioral parity with the reference's StorageService
(``app/services/storage_service.py:34-71,75-144``):
sequential filenames ``<prefix>N.<ext>`` in the output directory, loads pick
the highest N, IO errors return ``None`` instead of raising.  The output
directory is read from :mod:`simplex_tpu.config` at call time (fixing the
reference's import-by-value bug its own tests trip over, SURVEY.md §4).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

from .. import config


class StorageService:
    """Sequential-numbered artifact store."""

    def __init__(self, output_dir: Optional[str] = None):
        self._dir = output_dir

    @property
    def output_dir(self) -> str:
        d = self._dir or config.OUTPUT_DIR
        os.makedirs(d, exist_ok=True)
        return d

    # ------------------------------------------------------------------ #
    # filename sequencing                                                 #
    # ------------------------------------------------------------------ #
    def _numbered(self, prefix: str, ext: str) -> List[tuple]:
        pat = re.compile(re.escape(prefix) + r"(\d+)\." + re.escape(ext) + r"$")
        out = []
        try:
            for name in os.listdir(self.output_dir):
                m = pat.match(name)
                if m:
                    out.append((int(m.group(1)), name))
        except OSError:
            return []
        return sorted(out)

    def next_path(self, prefix: str, ext: str = "json") -> str:
        nums = self._numbered(prefix, ext)
        n = nums[-1][0] + 1 if nums else 1
        return os.path.join(self.output_dir, f"{prefix}{n}.{ext}")

    def latest_path(self, prefix: str, ext: str = "json") -> Optional[str]:
        nums = self._numbered(prefix, ext)
        if not nums:
            return None
        return os.path.join(self.output_dir, nums[-1][1])

    # ------------------------------------------------------------------ #
    # JSON round-trip                                                     #
    # ------------------------------------------------------------------ #
    def save_json(self, prefix: str, data: Dict) -> Optional[str]:
        path = self.next_path(prefix)
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(data, f, indent=2, ensure_ascii=False)
            return path
        except IOError:
            return None

    def load_json(self, prefix: str) -> Optional[Dict]:
        path = self.latest_path(prefix)
        if path is None:
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (IOError, json.JSONDecodeError):
            return None

    # ------------------------------------------------------------------ #
    # typed helpers (same prefixes as the reference, config.py)           #
    # ------------------------------------------------------------------ #
    def save_objective(self, data: Dict) -> Optional[str]:
        return self.save_json(config.PREFIX_FUNCION_OBJETIVO, data)

    def load_objective(self) -> Optional[Dict]:
        return self.load_json(config.PREFIX_FUNCION_OBJETIVO)

    def save_constraints(self, data: Any) -> Optional[str]:
        return self.save_json(config.PREFIX_RESTRICCIONES, data)

    def load_constraints(self) -> Optional[Any]:
        return self.load_json(config.PREFIX_RESTRICCIONES)

    def save_solution(self, report: Dict) -> Optional[str]:
        return self.save_json(config.PREFIX_SOLUCION, report)

    def load_solution(self) -> Optional[Dict]:
        return self.load_json(config.PREFIX_SOLUCION)

    def save_problem(self, problem: Dict) -> Optional[str]:
        return self.save_json(config.PREFIX_PROBLEMA, problem)

    def load_problem(self) -> Optional[Dict]:
        return self.load_json(config.PREFIX_PROBLEMA)

    def new_pdf_path(self) -> str:
        return self.next_path(config.PREFIX_PDF, ext="pdf")
