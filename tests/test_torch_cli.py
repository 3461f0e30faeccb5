"""The port's CLI beyond ``solve``: ``interactive`` (also the command when
none is given) with scripted input, as ``tests/test_cli.py:29-61`` drives
the prompts, ``export-pdf``, and ``serve`` up to the server (none is
started).  The ``gpu`` cases hold the revised engine and the MPS branch on
the card to the CPU path.  Nothing here imports JAX, so on a machine with a
card and no JAX the file runs alone:

    python -m pytest tests/test_torch_cli.py -m gpu --noconftest
"""
import io
import re

import pytest
import torch

from _torch_parity import CPU, bounded_lp, z_close

import simplex_tpu_torch as pt
import simplex_tpu_torch.config as t_config
from simplex_tpu_torch import cli
from simplex_tpu_torch.services.storage import StorageService
from simplex_tpu_torch.utils.mps import (
    generate_netlib_adversarial,
    generate_netlib_style,
)
from simplex_tpu_torch.web import microweb

@pytest.fixture
def storage(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.delenv("SIMPLEX_TPU_DEVICE", raising=False)
    return StorageService(str(tmp_path))


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _stdin(monkeypatch, lines):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))


SCRIPT = ["banana", "max", "Z = 3x1 + 5x2",          # one retry
          "x1 >= 0",                                  # rejected
          "x1 <= 4", "2x2 <= 12", "3x1 + 2x2 <= 18", "fin"]


def test_interactive_defines_saves_and_solves(storage, monkeypatch, capsys):
    _stdin(monkeypatch, SCRIPT)
    assert cli.main(["interactive", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "no-negatividad" in out
    assert "Solucion Factible" in out
    assert "x1 = 2.0000" in out and "Z = 36.0000" in out
    saved = storage.load_problem()["problema_definicion"]
    assert saved["funcion_objetivo"] == {
        "type": "maximize", "coefficients": {"x1": 3.0, "x2": 5.0}}
    assert len(saved["restricciones"]) == 3
    sol = storage.load_solution()["solucion_encontrada"]
    assert sol["valor_optimo_z"] == pytest.approx(36.0)


def test_interactive_aborts_without_constraints(storage, monkeypatch):
    _stdin(monkeypatch, ["min", "Z = 1x1 + 1x2", "fin"])
    assert cli.main(["interactive", "--device", CPU]) == 1
    assert storage.load_solution() is None


def test_no_command_is_interactive(storage, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "cmd_interactive",
                        lambda args: seen.append(args.command) or 7)
    assert cli.main([]) == 7
    assert seen == [None]


def test_interactive_raises_before_the_prompts_without_a_gpu(storage,
                                                              monkeypatch):
    _no_gpu()
    _stdin(monkeypatch, [])              # a prompt would hit EOF instead
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["interactive"])


def test_export_pdf_writes_the_latest_solution(storage, capsys):
    assert cli.main(["export-pdf"]) == 1
    assert "No se encontró una solución" in capsys.readouterr().out
    storage.save_problem({"problema_definicion": {
        "funcion_objetivo": {"type": "minimize",
                             "coefficients": {"x1": 2.0, "x2": 3.0}},
        "restricciones": [
            {"coefficients": {"x1": 1.0, "x2": 1.0}, "operator": ">=",
             "rhs": 5.0},
            {"coefficients": {"x1": 2.0, "x2": 1.0}, "operator": ">=",
             "rhs": 8.0}]}})
    assert cli.main(["solve-latest", "--device", CPU]) == 0
    assert "Z = 10.0000" in capsys.readouterr().out
    assert cli.main(["export-pdf"]) == 0
    out = capsys.readouterr().out
    path = re.search(r"Reporte PDF generado: (\S+)", out).group(1)
    assert path.endswith("reporte_solucion_1.pdf")
    with open(path, "rb") as f:
        pdf = f.read()
    assert pdf.startswith(b"%PDF-") and b"Z = 10.0000" in pdf


def test_serve_parses_and_hands_the_app_to_the_server(storage,
                                                      monkeypatch):
    args = cli.build_parser().parse_args(["serve"])
    assert (args.host, args.port, args.device) == ("0.0.0.0", 5000, "cuda")
    served = []
    monkeypatch.setattr(microweb, "run_dev_server",
                        lambda app, host, port: served.append((app, host,
                                                               port)))
    assert cli.main(["serve", "--host", "127.0.0.1", "--port", "8123",
                     "--device", CPU]) == 0
    (app, host, port), = served
    assert (host, port) == ("127.0.0.1", 8123)
    client = microweb.TestClient(app)
    client.post("/new", data={
        "problem_type": "maximize", "objective[]": ["3", "5"],
        "constraint_1[]": ["1", "0", "3"], "constraint_2[]": ["0", "2", "2"],
        "constraint_sign[]": ["<=", "<=", "<="],
        "constraint_rhs[]": ["4", "12", "18"]})
    assert "36.0000" in client.post("/solve").text


def test_serve_raises_without_a_gpu(storage, monkeypatch):
    _no_gpu()
    monkeypatch.setattr(microweb, "run_dev_server",
                        lambda *a, **k: pytest.fail("server started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve"])


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_revised_on_the_card_agrees_with_the_cpu_path():
    _gpu()
    lps = [generate_netlib_style(1, m=120, n=400),
           generate_netlib_style(3, m=20, n=48, n_free=6)]
    lps += [pt.LinearProgram(**bounded_lp(s)) for s in range(1, 9)]
    for lp in lps:
        gpu = pt.RevisedSimplexSolver(pt.SolverConfig()).solve(lp)
        cpu = pt.RevisedSimplexSolver(pt.SolverConfig(device=CPU)).solve(lp)
        assert (gpu.status, gpu.success, gpu.message) == \
            (cpu.status, cpu.success, cpu.message)
        if cpu.success:
            assert z_close(cpu.z, gpu.z)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["auto", "dense", "revised", "host"])
def test_mps_branch_on_the_card_agrees_with_the_cpu_path(engine, tmp_path,
                                                          capsys):
    _gpu()
    path = tmp_path / "adv.mps"
    path.write_text(generate_netlib_adversarial(1))
    out = {}
    for device in ("cuda", CPU):
        rc = cli.main(["solve", str(path), "--engine", engine,
                       "--device", device])
        text = capsys.readouterr().out
        z = re.search(r"Z = (\S+)", text)
        out[device] = (rc, re.search(r"motor (\w+)", text).group(1),
                       int(re.search(r"Estado: (-?\d+)", text).group(1)),
                       float(z.group(1)) if z else None)
    assert out["cuda"][:3] == out[CPU][:3]
    if out[CPU][3] is not None:
        assert z_close(out[CPU][3], out["cuda"][3])
