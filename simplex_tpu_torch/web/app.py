"""Web application: the reference's 8 HTTP routes on the micro-framework.

Route parity with ``app/controllers/ui_controller.py``:
``GET /``, ``GET|POST /new``, ``GET|POST /load``, ``POST /preview``,
``POST /procesar_formulario``, ``POST /solve``, ``GET /exportar-pdf``,
``GET /descargar-problema-json`` — same form-field names
(``problem_type``, ``objective[]``, ``constraint_<j>[]``,
``constraint_sign[]``, ``constraint_rhs[]``, ``problem_file``), same
session flow (problem wrapper stored on preview, consumed+popped by
``/solve``), same flash-and-redirect error UX.

Deliberate fix vs the reference: ``/solve`` also persists the problem JSON,
so ``/descargar-problema-json`` works without ever running the CLI
(the reference never writes ``problema_N.json`` from the web path, making
its download endpoint 404 until one exists).

Port of ``simplex_tpu/web/app.py`` with the same routes, forms, templates
and messages.  ``/solve`` runs the port's orchestrator on
``config.device`` (``SolverConfig.from_env()`` unless the factory is given
a config; ``cuda`` by default), and the factory raises where that device
is a GPU and none is present, so the app never solves on the CPU unasked.
``/metrics`` reads the port's ``utils/profiling.DEFAULT_METRICS``, its
span totals and ``models/certify.ESCALATIONS``.
"""
from __future__ import annotations

import json
import os

from .. import config
from ..config import SolverConfig, torch_device
from ..controllers.orchestrator import SolverOrchestrator
from ..core.problem import validate_problem_structure
from ..services.storage import StorageService
from ..services.pdf import PdfReportService
from .microweb import Response, WebApp

_HERE = os.path.dirname(__file__)


def init_app(storage: StorageService = None,
             solver_config: SolverConfig = None) -> WebApp:
    """App factory (the reference's ``init_app``, ``routers.py:9-25``).

    ``solver_config`` defaults to ``SolverConfig.from_env()``; its device
    must be present (see :func:`simplex_tpu_torch.config.torch_device`).
    """
    solver_config = solver_config or SolverConfig.from_env()
    torch_device(solver_config.device)
    app = WebApp(
        template_dir=os.path.join(_HERE, "templates"),
        static_dir=os.path.join(_HERE, "static"),
        secret_key=config.SECRET_KEY,
    )
    store = storage or StorageService()

    @app.route("/", methods=["GET"])
    def index(ctx):
        return ctx.render("index.html")

    @app.route("/new", methods=["GET", "POST"])
    def new_problem(ctx):
        if ctx.request.method == "POST":
            form = ctx.request.form
            problem_type = form.get("problem_type", "maximize")
            objective_list = form.getlist("objective[]")
            signs = form.getlist("constraint_sign[]")
            rhs_list = form.getlist("constraint_rhs[]")

            num_vars = len(objective_list)
            objective = {
                "type": problem_type,
                "coefficients": {
                    f"x{i+1}": float(objective_list[i] or 0.0)
                    for i in range(num_vars)
                },
            }
            restricciones = []
            for i in range(len(signs)):
                coefs = {}
                for j in range(num_vars):
                    vals = form.getlist(f"constraint_{j+1}[]")
                    v = vals[i] if i < len(vals) else ""
                    coefs[f"x{j+1}"] = float(v) if v else 0.0
                restricciones.append({
                    "coefficients": coefs,
                    "operator": signs[i],
                    "rhs": float(rhs_list[i]) if rhs_list[i] else 0.0,
                })
            problem_data = {"funcion_objetivo": objective,
                            "restricciones": restricciones}
            ctx.session["problem_data_wrapper"] = {
                "problema_definicion": problem_data}
            return ctx.render("preview.html", problem_data=problem_data,
                              from_page="new")
        return ctx.render("new_problem.html")

    @app.route("/load", methods=["GET", "POST"])
    def load_problem(ctx):
        if ctx.request.method == "POST":
            f = ctx.request.files.get("problem_file")
            if not f or not f.filename:
                ctx.flash("Selecciona un archivo antes de continuar.",
                          "error")
                return ctx.redirect("/load")
            if f.filename.lower().endswith((".mps", ".sif")):
                # Additive: netlib MPS upload — lowered to the report
                # schema's problem dict when expressible (the dict has no
                # bounds vocabulary, so free-variable LPs are directed to
                # the CLI, which solves them through the direct-engine
                # path).
                from ..utils.mps import parse_mps

                try:
                    lp = parse_mps(f.read().decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    ctx.flash(f"Archivo MPS inválido: {e}", "error")
                    return ctx.redirect("/load")
                if lp.has_free:
                    ctx.flash(
                        "El MPS contiene variables libres (FR/MI), que el "
                        "esquema del problema web no puede expresar; usa "
                        "'python -m simplex_tpu_torch.cli solve archivo.mps'.",
                        "error")
                    return ctx.redirect("/load")
                problem = lp.to_problem_dict()
                ctx.session["problem_data_wrapper"] = {
                    "problema_definicion": problem}
                return ctx.render("preview.html", problem_data=problem,
                                  from_page="load")
            try:
                content = json.loads(f.read().decode("utf-8"))
            except Exception as e:
                ctx.flash(f"Archivo JSON inválido: {e}", "error")
                return ctx.redirect("/load")
            problem = (content or {}).get("problema_definicion") \
                if isinstance(content, dict) else None
            if not problem:
                ctx.flash("El archivo no contiene 'problema_definicion'. "
                          "Asegurate de subir el JSON exportado por la "
                          "aplicación.", "error")
                return ctx.redirect("/load")
            ok, msg = validate_problem_structure(problem)
            if not ok:
                ctx.flash(msg, "error")
                return ctx.redirect("/load")
            ctx.session["problem_data_wrapper"] = {
                "problema_definicion": problem}
            return ctx.render("preview.html", problem_data=problem,
                              from_page="load")
        return ctx.render("load_problem.html")

    @app.route("/preview", methods=["POST"])
    def preview_problem(ctx):
        try:
            form = ctx.request.form
            problem_data = {
                "funcion_objetivo": {
                    "type": form.get("tipo", "maximize"),
                    "coefficients": json.loads(
                        form.get("coeficientes", "{}")),
                },
                "restricciones": json.loads(
                    form.get("restricciones", "[]")),
            }
            ctx.session["problem_data_wrapper"] = {
                "problema_definicion": problem_data}
            return ctx.render("preview.html", problem_data=problem_data,
                              from_page="new")
        except Exception as e:
            ctx.flash(f"Error al procesar el problema: {e}", "error")
            return ctx.redirect("/new")

    @app.route("/procesar_formulario", methods=["POST"])
    def procesar_formulario(ctx):
        try:
            data = json.loads(ctx.request.body.decode("utf-8"))
        except Exception:
            data = None
        return Response(
            json.dumps({"status": "ok", "data_recibida": data}),
            content_type="application/json",
        )

    @app.route("/solve", methods=["POST"])
    def solve_problem(ctx):
        try:
            wrapper = ctx.session.get("problem_data_wrapper")
            if not wrapper:
                ctx.flash("No se encontró ningún problema en la sesión. "
                          "Por favor, cargue el problema de nuevo.", "error")
                return ctx.redirect("/new")
            solver = SolverOrchestrator(wrapper, solver_config,
                                        storage=store)
            report = solver.run()
            ctx.session.pop("problem_data_wrapper", None)
            if not report:
                ctx.flash("Ocurrió un error durante la resolución.", "error")
                return ctx.redirect("/")
            store.save_problem(
                {"problema_definicion": report["problema_definicion"]})
            return ctx.render("solution.html", solucion=report)
        except Exception as e:
            ctx.flash(f"Error durante la resolución: {e}", "error")
            return ctx.redirect("/")

    @app.route("/exportar-pdf", methods=["GET"])
    def exportar_pdf(ctx):
        try:
            report = store.load_solution()
            if not report:
                ctx.flash("No se encontró una solución para exportar.",
                          "error")
                return ctx.redirect("/")
            pdf_path = store.new_pdf_path()
            PdfReportService(report, pdf_path).generate()
            return app.send_file(pdf_path,
                                 download_name=os.path.basename(pdf_path))
        except FileNotFoundError as e:
            ctx.flash(f"Error al cargar el reporte: {e}", "error")
            return ctx.redirect("/")
        except Exception as e:
            ctx.flash(f"Error al generar el PDF: {e}", "error")
            return ctx.redirect("/")

    @app.route("/descargar-problema-json", methods=["GET"])
    def descargar_problema_json(ctx):
        path = store.latest_path(config.PREFIX_PROBLEMA)
        if not path:
            return Response(
                "No hay un archivo de problema disponible para descargar.",
                status=404, content_type="text/plain; charset=utf-8")
        return app.send_file(path, download_name=os.path.basename(path))

    @app.route("/metrics", methods=["GET"])
    def metrics(ctx):
        # Additive observability endpoint (the reference has none,
        # SURVEY.md §5.5): aggregate solve counters as JSON, with the
        # instances the certifiers re-solved on the exact host engine.
        import json as _json

        from ..models import certify
        from ..utils.profiling import DEFAULT_METRICS, span_stats
        body = _json.dumps({"solves": DEFAULT_METRICS.summary(),
                            "spans": span_stats(),
                            "escalations": certify.ESCALATIONS})
        return Response(body, content_type="application/json")

    return app


def main():
    from .microweb import run_dev_server
    run_dev_server(init_app(), host="0.0.0.0", port=5000)


if __name__ == "__main__":
    main()
