"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (``--device cpu``), plants
one fault in the program (``lpbench/faults.py``) and drives the rest of a
tiny run in this process.  The faults a cell can have: a step that returns
its state unchanged, half of the batch left out (batched cells), an answer
altered where it is produced.  The cells run on one card, so no exchange
between cards is left out.
"""
import json

import pytest

from lpbench import faults, harness, registry, run
from lpbench.tests import _tiny


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults")
    # A small iteration cap, so that a stalled loop gives up quickly (the
    # dense loop then returns status 1: no time limit was reached).
    lp = _tiny.make(str(root), batch=8, max_iters=60)
    return root, lp


def _run(copy, cell, capsys, monkeypatch, kind):
    root, lp = copy
    monkeypatch.setattr(registry, "ROOT", lp)
    with faults.planted(kind):
        rc = run.main(["--workload", cell, "--seed", "3000000023",
                       "--seconds", "0.01", "--trace", "0", "--device",
                       "cpu"], manifest_path=str(root / "BENCHMARK.json"))
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,kind", [
    ("tiny.classic", "step_noop"), ("tiny.bounded", "step_noop"),
    ("tiny.classic", "half_batch"), ("tiny.bounded", "half_batch"),
    ("tiny.dense", "step_noop"),
    ("tiny.classic", "alter_answer"), ("tiny.bounded", "alter_answer"),
    ("tiny.dense", "alter_answer")])
def test_a_fault_makes_the_run_not_correct(copy, capsys, monkeypatch, cell,
                                           kind):
    res = _run(copy, cell, capsys, monkeypatch, kind)
    assert res["correct"] is False
    failed = [k for k, (v, lim) in res["checks"].items()
              if v is None or v > lim]
    assert failed


def test_without_a_fault_the_same_runs_are_correct(copy, capsys,
                                                   monkeypatch):
    root, lp = copy
    monkeypatch.setattr(registry, "ROOT", lp)
    for cell in sorted(_tiny.TINY):
        rc = run.main(["--workload", cell, "--seed", "3000000023",
                       "--seconds", "0.01", "--trace", "0", "--device",
                       "cpu"], manifest_path=str(root / "BENCHMARK.json"))
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["correct"] is True


def test_a_stalled_dense_loop_past_its_time_limit_goes_to_the_host(
        copy, monkeypatch):
    """Under the cell's own configuration (no iteration cap of the tests'
    copy) a stalled dense loop stops at ``SolverConfig.time_limit`` and
    ``solve_lp`` re-solves the LP in float64 on the host: the answer is
    right and escalated, and the fault shows in ``solve_s``.  Here with a
    time limit of a tenth of a second."""
    root, lp = copy
    monkeypatch.setattr(registry, "ROOT", lp)
    cell = registry.cell("tiny.dense",
                         registry.manifest(str(root / "BENCHMARK.json")))
    cell["config"]["solver"] = {"dtype": "float32", "time_limit": 0.1}
    traffic = dict(cell["traffic"], **{k: cell["config"][k]
                                       for k in ("m", "n", "dtype")})
    from lpbench.traffic import generate

    pool = generate.pool(traffic, 3000000029)
    entry = registry.module("entries", "solve_lp").make("cpu", cell)
    with faults.planted("step_noop"):
        calls = [(k, entry.call(it)) for k, it in enumerate(pool)]
    r = harness.readings_of(calls, pool, harness.references(pool, "cpu"))
    assert r["escalated_share"] == 1.0
    ok, _ = harness.compare.judge(r, cell["workload"]["limits"])
    assert ok
