"""The report path of the port (orchestrator, history, CLI) against the JAX
package's on the three anchors: the same report, tables at 4 dp included."""
import json
import re

import pytest

from _torch_parity import ANCHORS, ANCHOR_Z, CPU, anchor_wrapper

import simplex_tpu.config as j_config
import simplex_tpu_torch.config as t_config
from simplex_tpu import cli as j_cli
from simplex_tpu.controllers.orchestrator import \
    solve_problem_dict as j_solve_problem_dict
from simplex_tpu_torch import cli as t_cli
from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.controllers.orchestrator import \
    solve_problem_dict as t_solve_problem_dict


@pytest.fixture
def outdir(tmp_path, monkeypatch):
    monkeypatch.setattr(j_config, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_report_equals_reference(i):
    wrapper = anchor_wrapper(ANCHORS[i])
    ref = j_solve_problem_dict(wrapper, save=False)
    got = t_solve_problem_dict(wrapper, SolverConfig(device=CPU), save=False)
    assert got["solucion_encontrada"] == ref["solucion_encontrada"]
    assert got["analisis_sensibilidad"] == ref["analisis_sensibilidad"]
    assert got["tablas_intermedias"] == ref["tablas_intermedias"]
    assert got == ref
    sol = got["solucion_encontrada"]
    assert sol["status"] == "Solucion Factible"
    assert round(sol["valor_optimo_z"], 4) == ANCHOR_Z[i]
    assert got["tablas_intermedias"]


def _z_line(text):
    return re.findall(r"Z = (-?[0-9.]+)", text)


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_cli_solve_prints_the_same_z(i, outdir, capsys):
    path = outdir / f"anchor{i}.json"
    path.write_text(json.dumps(anchor_wrapper(ANCHORS[i])))
    assert j_cli.main(["solve", str(path)]) == 0
    ref = capsys.readouterr().out
    assert t_cli.main(["solve", str(path), "--device", CPU]) == 0
    got = capsys.readouterr().out
    assert _z_line(got) == _z_line(ref) == [f"{ANCHOR_Z[i]:.4f}"]
    assert got == ref


def test_cli_solve_latest_uses_the_saved_problem(outdir, capsys):
    t_config_storage = __import__("simplex_tpu_torch.services.storage",
                                  fromlist=["StorageService"])
    t_config_storage.StorageService().save_problem(anchor_wrapper(ANCHORS[2]))
    assert t_cli.main(["solve-latest", "--device", CPU]) == 0
    assert _z_line(capsys.readouterr().out) == ["10.0000"]
    saved = t_config_storage.StorageService().load_solution()
    assert saved["solucion_encontrada"]["valor_optimo_z"] == pytest.approx(10)


def test_cli_rejects_a_file_without_a_problem(outdir, capsys):
    path = outdir / "empty.json"
    path.write_text("{}")
    assert t_cli.main(["solve", str(path), "--device", CPU]) == 1
