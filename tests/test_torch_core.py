"""The port's copies of the numpy-only modules stay equal to their originals.

``simplex_tpu_torch`` cannot import ``simplex_tpu`` (its ``__init__`` pulls
in JAX), so it carries copies of ``core/`` and of the storage and
visualization services.  These tests hold each copy to its source: the
text (apart from the one header line and the reference-project path
prefix in docstrings) and the results on the same inputs.
"""
import os
import re

import numpy as np
import pytest

from _torch_parity import ANCHORS, anchor_wrapper, seeded_lp

import simplex_tpu.core.parsing as j_parsing
import simplex_tpu.core.presolve as j_presolve
import simplex_tpu.core.problem as j_problem
import simplex_tpu.services.history as j_history
import simplex_tpu.services.storage as j_storage
import simplex_tpu.services.viz as j_viz
import simplex_tpu_torch.core.parsing as t_parsing
import simplex_tpu_torch.core.presolve as t_presolve
import simplex_tpu_torch.core.problem as t_problem
import simplex_tpu_torch.services.history as t_history
import simplex_tpu_torch.services.storage as t_storage
import simplex_tpu_torch.services.viz as t_viz

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COPIES = ["core/parsing.py", "core/problem.py", "core/presolve.py",
          "services/storage.py", "services/viz.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    with open(os.path.join(REPO, "simplex_tpu", rel), encoding="utf-8") as f:
        src = f.read()
    with open(os.path.join(REPO, "simplex_tpu_torch", rel),
              encoding="utf-8") as f:
        header, copy = f.read().split("\n", 1)
    assert header == (f"# Copied from simplex_tpu/{rel}; keep in step "
                      "(tests/test_torch_core.py).")
    assert copy == re.sub(r"/\w+/reference/", "", src)


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
