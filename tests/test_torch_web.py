"""The port's web app (``simplex_tpu_torch/web/app.py``) through its in-process
client: the routes of ``tests/test_web_app.py``, and on the three anchors the
same pages as the JAX app's (the report's tables at 4 dp included)."""
import json

import pytest
import torch

from _torch_parity import ANCHORS, ANCHOR_Z, CPU

import simplex_tpu.config as j_config
import simplex_tpu_torch.config as t_config
from simplex_tpu.services.storage import StorageService as JStorage
from simplex_tpu.web.app import init_app as j_init_app
from simplex_tpu.web.microweb import TestClient as JClient
from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.models import certify as t_certify
from simplex_tpu_torch.services.storage import StorageService
from simplex_tpu_torch.utils import profiling
from simplex_tpu_torch.web.app import init_app
from simplex_tpu_torch.web.microweb import TestClient


@pytest.fixture
def client(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    return TestClient(init_app(storage=StorageService(str(tmp_path)),
                               solver_config=SolverConfig(device=CPU)))


@pytest.fixture
def ref_client(tmp_path_factory, monkeypatch):
    out = tmp_path_factory.mktemp("jax_app")
    monkeypatch.setattr(j_config, "OUTPUT_DIR", str(out))
    return JClient(j_init_app(storage=JStorage(str(out))))


MAX_FORM = {
    "problem_type": "maximize",
    "objective[]": ["3", "5"],
    "constraint_1[]": ["1", "0", "3"],
    "constraint_2[]": ["0", "2", "2"],
    "constraint_sign[]": ["<=", "<=", "<="],
    "constraint_rhs[]": ["4", "12", "18"],
}


def _form(kw):
    """An anchor as the /new form."""
    op_str = {-1: "<=", 0: "=", 1: ">="}
    form = {"problem_type": "maximize" if kw["maximize"] else "minimize",
            "objective[]": [repr(v) for v in kw["c"]],
            "constraint_sign[]": [op_str[o] for o in kw["ops"]],
            "constraint_rhs[]": [repr(v) for v in kw["b"]]}
    for j in range(len(kw["c"])):
        form[f"constraint_{j + 1}[]"] = [repr(row[j]) for row in kw["A"]]
    return form


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_anchor_solution_page_equals_the_jax_app(i, client, ref_client):
    form = _form(ANCHORS[i])
    pages = []
    for c in (ref_client, client):
        r = c.post("/new", data=form)
        assert r.status_code == 200 and "Vista previa" in r.text
        r = c.post("/solve")
        assert r.status_code == 200
        pages.append(r.text)
    ref, got = pages
    assert "Solucion Factible" in got
    assert f"{ANCHOR_Z[i]:.4f}" in got
    assert "Iteración 0 (Tabla Inicial)" in got
    assert got == ref


def test_index(client):
    r = client.get("/")
    assert r.status_code == 200
    assert "simplex_tpu" in r.text


def test_new_get_shows_form(client):
    r = client.get("/new")
    assert r.status_code == 200
    assert "objective" in r.text


def test_new_post_previews_and_solve_solves(client):
    r = client.post("/new", data=MAX_FORM)
    assert r.status_code == 200
    assert "Vista previa" in r.text

    r = client.post("/solve")
    assert r.status_code == 200
    assert "Solucion Factible" in r.text
    assert "36.0000" in r.text
    assert "gilp-container" in r.text
    assert "stx-svg" in r.text
    assert "Iteración 0 (Tabla Inicial)" in r.text
    assert "background-color:#fff0f0" in r.text


def test_solve_without_session_redirects(client):
    r = client.post("/solve", follow_redirects=True)
    assert "No se encontró ningún problema" in r.text


def test_session_popped_after_solve(client):
    client.post("/new", data=MAX_FORM)
    client.post("/solve")
    r = client.post("/solve", follow_redirects=True)
    assert "No se encontró ningún problema" in r.text


def test_export_pdf_roundtrip(client):
    client.post("/new", data=MAX_FORM)
    client.post("/solve")
    r = client.get("/exportar-pdf")
    assert r.status_code == 200
    assert r.data.startswith(b"%PDF-")
    assert b"Z = 36.0000" in r.data


def test_export_pdf_without_solution_flashes(client):
    r = client.get("/exportar-pdf", follow_redirects=True)
    assert "No se encontró una solución" in r.text


def test_download_and_reload_problem_json(client):
    client.post("/new", data=MAX_FORM)
    client.post("/solve")
    r = client.get("/descargar-problema-json")
    assert r.status_code == 200
    doc = json.loads(r.data)
    assert doc["problema_definicion"]["funcion_objetivo"]["type"] == "maximize"

    r = client.post("/load",
                    files={"problem_file": ("p.json", json.dumps(doc))})
    assert "Vista previa" in r.text
    r = client.post("/solve")
    assert "36.0000" in r.text


def test_load_bounded_problem_solves_through_web(client):
    doc = {"problema_definicion": {
        "funcion_objetivo": {"type": "maximize",
                             "coefficients": {"x1": 1.0, "x2": 0.1}},
        "restricciones": [{"coefficients": {"x1": 1.0, "x2": 1.0},
                           "operator": "<=", "rhs": 10.0}],
        "bounds": {"lb": {}, "ub": {"x1": 2.0, "x2": 3.0}},
    }}
    r = client.post("/load",
                    files={"problem_file": ("p.json", json.dumps(doc))})
    assert "Vista previa" in r.text
    r = client.post("/solve")
    assert "2.3000" in r.text


def test_load_rejects_garbage(client):
    r = client.post("/load", files={"problem_file": ("x.json", "{oops")},
                    follow_redirects=True)
    assert "inválido" in r.text
    r = client.post("/load",
                    files={"problem_file": ("x.json", json.dumps({"a": 1}))},
                    follow_redirects=True)
    assert "problema_definicion" in r.text


def test_load_validates_structure(client):
    bad = {"problema_definicion": {
        "funcion_objetivo": {"type": "maximize", "coefficients": {"x1": 1.0}},
        "restricciones": [
            {"coefficients": {"x1": 1.0}, "operator": "<<", "rhs": 1.0}
        ],
    }}
    r = client.post("/load",
                    files={"problem_file": ("x.json", json.dumps(bad))},
                    follow_redirects=True)
    assert "operator" in r.text


def test_infeasible_solution_page(client):
    form = {
        "problem_type": "maximize",
        "objective[]": ["1"],
        "constraint_1[]": ["1", "1"],
        "constraint_sign[]": ["<=", ">="],
        "constraint_rhs[]": ["1", "3"],
    }
    client.post("/new", data=form)
    r = client.post("/solve")
    assert "Sin Solucion Factible" in r.text


def test_procesar_formulario_echo(client):
    r = client.post("/procesar_formulario")
    assert r.status_code == 200
    assert json.loads(r.data)["status"] == "ok"


def test_static_css_served(client):
    r = client.get("/static/style.css")
    assert r.status_code == 200
    assert "--accent" in r.text


def test_unknown_route_404(client):
    assert client.get("/nope").status_code == 404


def test_metrics_endpoint_shows_the_solve_record(client):
    r = client.get("/metrics")
    assert r.status == 200
    before = json.loads(r.text)["solves"].get("solves", 0)
    n_records = len(profiling.DEFAULT_METRICS.records)

    client.post("/new", data=MAX_FORM)
    client.post("/solve")
    data = json.loads(client.get("/metrics").text)
    assert data["solves"]["solves"] == before + 1
    assert data["solves"]["optimal"] >= 1
    rec = profiling.DEFAULT_METRICS.records[n_records]
    assert (rec.engine, rec.status, rec.n_vars, rec.n_cons) == \
        ("dense", 0, 2, 3)


def test_metrics_endpoint_exports_the_escalation_counter(client):
    before = json.loads(client.get("/metrics").text)["escalations"]
    assert before == t_certify.ESCALATIONS
    t_certify.count_escalation()
    assert json.loads(client.get("/metrics").text)["escalations"] == \
        before + 1


def test_load_mps_upload(client):
    mps = """NAME T
ROWS
 N  OBJ
 L  R1
 L  R2
COLUMNS
    X1        OBJ         -3.0   R1           1.0
    X2        OBJ         -5.0   R2           2.0
    X1        R2           0.0
RHS
    RHS       R1           4.0   R2          12.0
ENDATA
"""
    r = client.post("/load", files={"problem_file": ("t.mps", mps)})
    assert r.status_code == 200
    r2 = client.post("/solve")
    assert r2.status_code == 200 and "Solucion Factible" in r2.text


def test_load_mps_free_vars_rejected(client):
    mps = """NAME T
ROWS
 N  OBJ
 L  R1
COLUMNS
    X1        OBJ          1.0   R1           1.0
RHS
    RHS       R1           5.0
BOUNDS
 FR BND       X1
ENDATA
"""
    r = client.post("/load", files={"problem_file": ("t.mps", mps)},
                    follow_redirects=True)
    assert r.status_code == 200
    assert "variables libres" in r.text
    assert "python -m simplex_tpu_torch.cli solve archivo.mps" in r.text


def test_app_reads_its_device_from_the_environment(tmp_path, monkeypatch):
    """Without a config the factory takes ``SolverConfig.from_env()``:
    ``SIMPLEX_TPU_DEVICE=cpu`` solves on the CPU, and the default device
    raises where no GPU is present instead of solving on the CPU."""
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.setenv("SIMPLEX_TPU_DEVICE", CPU)
    c = TestClient(init_app(storage=StorageService(str(tmp_path))))
    c.post("/new", data=MAX_FORM)
    assert "36.0000" in c.post("/solve").text
    monkeypatch.delenv("SIMPLEX_TPU_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_app(storage=StorageService(str(tmp_path)))
