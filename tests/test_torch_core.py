"""The port's copies of the numpy-only modules stay equal to their originals.

``simplex_tpu_torch`` cannot import ``simplex_tpu`` (its ``__init__`` pulls
in JAX), so it carries copies of ``core/``, ``models/certify.py``, the
storage, visualization and PDF services, the MPS reader, the CLI prompts,
the web framework with its templates, the native host engine with its C++
source, and the numpy helpers of ``models/batched.py`` and
``models/dense.py``.  These tests hold each copy to its source: the text
(apart from a module's one header line, the reference-project path
prefix in docstrings, and the certifier's stage spans and escalation
counter) and the results on the same inputs.
"""
import inspect
import os
import re

import numpy as np
import pytest

from _torch_parity import ANCHORS, anchor_wrapper, bounded_lp, seeded_lp

from simplex_tpu.config import SolverConfig as j_cfg
from simplex_tpu_torch.config import SolverConfig as t_cfg

import simplex_tpu.core.parsing as j_parsing
import simplex_tpu.models.batched as j_batched
import simplex_tpu.models.dense as j_dense
import simplex_tpu.utils.mps as j_mps
import simplex_tpu.core.presolve as j_presolve
import simplex_tpu.core.problem as j_problem
import simplex_tpu.services.history as j_history
import simplex_tpu.services.storage as j_storage
import simplex_tpu.services.viz as j_viz
import simplex_tpu_torch.core.parsing as t_parsing
import simplex_tpu_torch.models.batched as t_batched
import simplex_tpu_torch.models.dense as t_dense
import simplex_tpu_torch.utils.mps as t_mps
import simplex_tpu_torch.core.presolve as t_presolve
import simplex_tpu_torch.core.problem as t_problem
import simplex_tpu_torch.services.history as t_history
import simplex_tpu_torch.services.storage as t_storage
import simplex_tpu_torch.services.viz as t_viz

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COPIES = ["core/parsing.py", "core/problem.py", "core/presolve.py",
          "services/storage.py", "services/viz.py", "models/certify.py",
          "utils/mps.py", "controllers/cli_io.py", "services/pdf.py",
          "web/microweb.py", "models/host.py", "runtime/native/__init__.py",
          "runtime/native/simplex_host.cpp", "models/crossover.py"]
# Files the web app reads, copied byte for byte (no header line).
WEB_FILES = ["web/templates/base.html", "web/templates/index.html",
             "web/templates/load_problem.html",
             "web/templates/new_problem.html", "web/templates/preview.html",
             "web/templates/solution.html", "web/static/style.css"]
# The numpy helpers that the port's models/batched.py copies as they are.
BATCHED_HELPERS = ["_round_up", "BatchResult", "CompiledBatch",
                   "_build_ub_ext", "compile_batch_uniform", "_batch_tol",
                   "certify_uniform_result", "solve_lp_sweep"]


# Copies that carry the port's stage spans and escalation counter
# (``utils/profiling.py``): apart from them they are the original's text.
INSTRUMENTED = {"models/certify.py"}
_PRELUDE = """from ..runtime import counters
from ..utils.profiling import count, trace_span

# Instances re-solved on the exact host engine since the counter was last
# reset to 0: every escalation loop here, and ``models/dense.py::solve_lp``,
# on every thread.  The web app's ``/metrics`` exports it.
ESCALATIONS = 0


def count_escalation():
    \"\"\"One instance escalated: :data:`ESCALATIONS` and the ``escalations``
    of the open solve record (``utils/profiling.py``) rise by one.\"\"\"
    counters.add(globals(), "ESCALATIONS")
    count("escalations")
"""
_SPAN = re.compile(r" *with trace_span\(\"[\w.]+\"\):\Z")


def _without_instrumentation(text):
    """``text`` without the port's instrumentation: the counter's prelude,
    each ``count_escalation()`` line, and each ``with trace_span(...):``
    line, with its block dedented."""
    assert text.count(_PRELUDE) == 1, "the counter's prelude is missing"
    text = text.replace(_PRELUDE, "")
    out, opened = [], []
    for line in text.split("\n"):
        if line.strip():
            indent = len(line) - len(line.lstrip())
            while opened and indent <= opened[-1]:
                opened.pop()
            if _SPAN.match(line):
                opened.append(indent)
                continue
            if line.strip() == "count_escalation()":
                continue
            line = line[4 * len(opened):]
        out.append(line)
    return "\n".join(out)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    with open(os.path.join(REPO, "simplex_tpu", rel), encoding="utf-8") as f:
        src = f.read()
    with open(os.path.join(REPO, "simplex_tpu_torch", rel),
              encoding="utf-8") as f:
        header, copy = f.read().split("\n", 1)
    comment = "//" if rel.endswith(".cpp") else "#"
    assert header == (f"{comment} Copied from simplex_tpu/{rel}; keep in "
                      "step (tests/test_torch_core.py).")
    if rel in INSTRUMENTED:
        copy = _without_instrumentation(copy)
    assert copy == re.sub(r"/\w+/reference/", "", src)


@pytest.mark.parametrize("rel", WEB_FILES)
def test_web_file_is_identical(rel):
    with open(os.path.join(REPO, "simplex_tpu", rel), "rb") as f:
        src = f.read()
    with open(os.path.join(REPO, "simplex_tpu_torch", rel), "rb") as f:
        assert f.read() == src


def test_web_files_are_all_copied():
    """No template or stylesheet of the JAX app is missing from the
    port's."""
    found = []
    for sub in ("templates", "static"):
        for name in os.listdir(os.path.join(REPO, "simplex_tpu", "web",
                                            sub)):
            found.append(f"web/{sub}/{name}")
    assert sorted(found) == sorted(WEB_FILES)


def test_finalize_on_host_bounded_is_verbatim():
    assert inspect.getsource(t_dense._finalize_on_host_bounded) == \
        inspect.getsource(j_dense._finalize_on_host_bounded)


@pytest.mark.parametrize("name", ["_refine_on_host", "_sensitivity_on_host",
                                  "_certify_optimal_basis"])
def test_reoptimize_host_helper_is_verbatim(name):
    """The numpy-only helpers of ``reoptimize``, copied as they are."""
    assert inspect.getsource(getattr(t_dense, name)) == \
        inspect.getsource(getattr(j_dense, name))


def test_public_names_equal_the_jax_package():
    import simplex_tpu
    import simplex_tpu_torch

    assert simplex_tpu_torch.__all__ == simplex_tpu.__all__
    for name in simplex_tpu_torch.__all__:
        assert hasattr(simplex_tpu_torch, name), name


@pytest.mark.parametrize("seed", [2, 7, 9])
def test_finalize_on_host_bounded_gives_the_same_certificate(seed):
    """One JAX revised solve of a bounded LP (a seed whose normalized LP
    has no free column), finalized by both copies."""
    from simplex_tpu.models.revised import RevisedSimplexSolver

    kw = bounded_lp(seed)
    lp_j, _ = j_problem.normalize_bounds(j_problem.LinearProgram(**kw))
    lp_t, _ = t_problem.normalize_bounds(t_problem.LinearProgram(**kw))
    res = RevisedSimplexSolver(j_cfg(presolve=False)).solve(lp_j)
    assert not lp_j.has_free and res.at_upper is not None
    sf_j = j_problem.compile_standard_form(lp_j, dtype=np.float64,
                                           bounded=True)
    sf_t = t_problem.compile_standard_form(lp_t, dtype=np.float64,
                                           bounded=True)
    a = j_dense._finalize_on_host_bounded(sf_j, lp_j, res.basis,
                                          res.at_upper, sf64=sf_j)
    b = t_dense._finalize_on_host_bounded(sf_t, lp_t, res.basis,
                                          res.at_upper, sf64=sf_t)
    assert a[0] == b[0] and a[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


MPS_CASES = ["testprob", "nlfree1", "adversarial", "netlib_style"]


def _mps_text(kind):
    from test_mps import NLFREE1, TESTPROB

    if kind == "testprob":
        return TESTPROB
    if kind == "nlfree1":
        return NLFREE1
    if kind == "adversarial":
        return t_mps.generate_netlib_adversarial(2)
    return None


@pytest.mark.parametrize("kind", MPS_CASES)
def test_mps_reader_gives_the_same_lp(kind):
    text = _mps_text(kind)
    if text is None:
        a = j_mps.generate_netlib_style(7, m=12, n=30, n_free=3)
        b = t_mps.generate_netlib_style(7, m=12, n=30, n_free=3)
    else:
        assert j_mps.generate_netlib_adversarial(2) == \
            t_mps.generate_netlib_adversarial(2)
        a, b = j_mps.parse_mps(text), t_mps.parse_mps(text)
    for f in ("c", "A", "b", "ops", "lb", "ub", "free"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.maximize, a.variables) == (b.maximize, b.variables)


def test_pdf_service_writes_the_same_bytes(tmp_path):
    from simplex_tpu.controllers.orchestrator import solve_problem_dict
    from simplex_tpu.services.pdf import PdfReportService as JPdf
    from simplex_tpu_torch.services.pdf import PdfReportService as TPdf

    report = solve_problem_dict(anchor_wrapper(ANCHORS[0]), save=False)
    JPdf(report, str(tmp_path / "a.pdf")).generate()
    TPdf(report, str(tmp_path / "b.pdf")).generate()
    assert (tmp_path / "a.pdf").read_bytes() == \
        (tmp_path / "b.pdf").read_bytes()



@pytest.mark.parametrize("name", BATCHED_HELPERS)
def test_batched_helper_is_verbatim(name):
    assert inspect.getsource(getattr(t_batched, name)) == \
        inspect.getsource(getattr(j_batched, name))


def test_batched_helpers_give_the_same_results():
    rng = np.random.default_rng(4)
    B, m, n = 5, 6, 4
    c, A = rng.normal(size=(B, n)), rng.normal(size=(B, m, n))
    b = rng.uniform(-2, 6, size=(B, m))
    ops = np.array([-1, 1, 0, -1, -1, 1])
    ub = np.where(rng.random((B, n)) < 0.5, np.inf, 3.0)
    for kw in ({}, {"ub": ub, "dtype": np.float64}, {"align_total": False}):
        a = j_batched.compile_batch_uniform(c, A, b, ops, True, **kw)
        t = t_batched.compile_batch_uniform(c, A, b, ops, True, **kw)
        for f in ("T0", "basis", "col_mask_p1", "col_mask_p2", "obj_row_p1",
                  "obj_row_p2", "need_p1", "maximize", "ub_ext"):
            x, y = getattr(a, f), getattr(t, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
                assert x.dtype == y.dtype, f
    for dt in (np.float32, np.float64):
        for tol in (1e-9, 1e-5):
            assert j_batched._batch_tol(j_cfg(tol=tol), dt) == \
                t_batched._batch_tol(t_cfg(tol=tol), dt)
    assert j_batched._round_up(13, 8) == t_batched._round_up(13, 8) == 16


def test_certify_uniform_result_gives_the_same_verdicts():
    """One JAX solve, certified by both copies of the certifier."""
    import dataclasses

    rng = np.random.default_rng(6)
    B, m, n = 6, 5, 4
    A = rng.uniform(0.1, 2.0, (B, m, n))
    c, b = rng.uniform(0.5, 3.0, (B, n)), rng.uniform(5.0, 25.0, (B, m))
    for ops in (np.full(m, -1), np.array([-1, 1, 0, -1, -1])):
        res = j_batched.BatchedSimplexSolver(j_cfg(certify=False)) \
            .solve_arrays(c, A, b, ops, maximize=True)
        res.basis = np.asarray(res.basis)
        a = j_batched.certify_uniform_result(dataclasses.replace(res), c, A,
                                             b, ops, True)
        t = t_batched.certify_uniform_result(dataclasses.replace(res), c, A,
                                             b, ops, True)
        for f in ("status", "x", "fun", "z", "certified", "escalated"):
            np.testing.assert_array_equal(getattr(a, f), getattr(t, f),
                                          err_msg=f)


def _sf_arrays(sf):
    return {k: getattr(sf, k) for k in (
        "tableau", "basis", "col_mask_p1", "col_mask_p2", "obj_row_p1",
        "obj_row_p2", "need_phase1", "n_vars", "n_rows", "n_cols",
        "maximize", "ub_ext")}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


CASES = [("anchor", i) for i in range(len(ANCHORS))] + \
        [("seeded", s) for s in range(10)]


def _lp_kw(kind, i):
    return ANCHORS[i] if kind == "anchor" else seeded_lp(100 + i)


@pytest.mark.parametrize("kind,i", CASES)
def test_compile_standard_form_identical(kind, i):
    kw = _lp_kw(kind, i)
    for args in ({}, {"row_pad": 16, "col_pad": 128, "dtype": np.float64}):
        a = j_problem.compile_standard_form(j_problem.LinearProgram(**kw),
                                            **args)
        b = t_problem.compile_standard_form(t_problem.LinearProgram(**kw),
                                            **args)
        _assert_same(_sf_arrays(a), _sf_arrays(b))


def _presolve_cases():
    yield dict(seeded_lp(7))
    # An empty row with a positive rhs under "=": infeasible.
    yield dict(c=[1.0, 2.0], A=[[0.0, 0.0], [1.0, 1.0]], b=[3.0, 4.0],
               ops=[0, -1], maximize=True)
    # Proportional "=" rows with inconsistent right-hand sides: infeasible.
    yield dict(c=[1.0, 1.0], A=[[1.0, 1.0], [2.0, 2.0]], b=[1.0, 3.0],
               ops=[0, 0], maximize=True)
    # A zero column and a duplicate row: reduced.
    yield dict(c=[1.0, 0.0, 2.0], A=[[1.0, 0.0, 1.0], [1.0, 0.0, 1.0],
                                     [0.0, 0.0, 1.0]],
               b=[4.0, 4.0, 3.0], ops=[-1, -1, -1], maximize=True)


@pytest.mark.parametrize("k", range(4))
def test_presolve_verdicts_identical(k):
    kw = list(_presolve_cases())[k]
    a = j_presolve.presolve(j_problem.LinearProgram(**kw))
    b = t_presolve.presolve(t_problem.LinearProgram(**kw))
    assert (a.status, a.decided, a.reduced) == (b.status, b.decided,
                                                b.reduced)
    np.testing.assert_array_equal(a.kept_rows, b.kept_rows)
    np.testing.assert_array_equal(a.kept_cols, b.kept_cols)
    if a.lp is not None:
        for f in ("c", "A", "b", "ops"):
            np.testing.assert_array_equal(getattr(a.lp, f), getattr(b.lp, f))


def test_equilibrate_identical():
    rng = np.random.default_rng(3)
    kw = seeded_lp(11)
    kw["A"] = kw["A"] * 10.0 ** rng.integers(-3, 4, size=kw["A"].shape)
    lp_a, eq_a = j_presolve.equilibrate(j_problem.LinearProgram(**kw))
    lp_b, eq_b = t_presolve.equilibrate(t_problem.LinearProgram(**kw))
    np.testing.assert_array_equal(lp_a.A, lp_b.A)
    np.testing.assert_array_equal(lp_a.b, lp_b.b)
    assert eq_a.identity == eq_b.identity
    assert j_presolve.coefficient_range(lp_a.A) == \
        t_presolve.coefficient_range(lp_b.A)


@pytest.mark.parametrize("expr", ["Z = 3x1 - 5x2", "max 2x1 + x2 + 0.5x3",
                                  "x1 + x2"])
def test_objective_parser_identical(expr):
    def run(mod):
        try:
            return mod.ObjectiveFunctionParser.parse(expr)
        except ValueError as e:
            return ("error", str(e))
    assert run(j_parsing) == run(t_parsing)


@pytest.mark.parametrize("expr", ["2x1 + 3x2 <= 5", "x1 - x2 >= -1",
                                  "x1 = 4", "2x1 + x3 <= 1"])
def test_constraint_parser_identical(expr):
    def run(mod):
        try:
            return mod.ConstraintsParser.parse(expr).to_dict()
        except ValueError as e:
            return ("error", str(e))
    assert run(j_parsing) == run(t_parsing)


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_history_tables_and_path_identical(i):
    """The copied table and vertex-path helpers give the same output on
    one history."""
    lp = j_problem.LinearProgram(**ANCHORS[i])
    hist = j_history.compute_pivot_history(lp)
    assert j_history.history_to_tables(hist) == \
        t_history.history_to_tables(hist)
    assert j_history.vertex_path_from_history(hist, lp.n_vars) == \
        t_history.vertex_path_from_history(hist, lp.n_vars)
    tables = j_history.history_to_tables(hist)
    path = j_history.vertex_path_from_history(hist, lp.n_vars)
    assert j_viz.build_visualization_html(lp, tables, path) == \
        t_viz.build_visualization_html(lp, tables, path)


def test_storage_round_trip_between_packages(tmp_path):
    """A problem saved by the port's storage loads through the JAX one and
    back (same prefixes, same numbering)."""
    wrapper = anchor_wrapper(ANCHORS[0])
    t_store = t_storage.StorageService(str(tmp_path))
    j_store = j_storage.StorageService(str(tmp_path))
    t_store.save_problem(wrapper)
    assert j_store.load_problem() == wrapper
    j_store.save_solution({"k": 1})
    t_store.save_solution({"k": 2})
    assert j_store.load_solution() == {"k": 2}
    assert t_store.load_solution() == {"k": 2}
