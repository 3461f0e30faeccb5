"""The per-layer metrics read from the program's own spans and counters
(``metrics/_program.py``): a traced tiny run of the batch cell reports
each of them, the escalations it reports agree with its answers, and a
program without solve records leaves them out."""
import json

import numpy as np
import pytest

from lpbench import faults, harness, registry, run
from lpbench.metrics import _program
from lpbench.tests import _tiny

PROGRAM_METRICS = ("assemble_s.batch", "certify_gather_s.batch",
                   "certify_lapack_s.batch", "certify_check_s.batch",
                   "escalate_s.batch", "escalations.batch",
                   "capture_s.batch")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("program")
    lp = _tiny.make(str(root), batch=12)
    return root, lp


def _traced(copy, capsys, monkeypatch, seed, fault=None):
    """One traced run of ``tiny.classic`` in this process: its result line
    and the record the metrics were read from."""
    root, lp = copy
    monkeypatch.setattr(registry, "ROOT", lp)
    seen = []
    real = harness.metric_values

    def keep(cell, record, trace):
        seen.append(record)
        return real(cell, record, trace)

    monkeypatch.setattr(harness, "metric_values", keep)
    argv = ["--workload", "tiny.classic", "--seed", str(seed),
            "--seconds", "0.3", "--trace", "1", "--device", "cpu"]
    if fault is None:
        rc = run.main(argv, manifest_path=str(root / "BENCHMARK.json"))
    else:
        with faults.planted(fault):
            rc = run.main(argv, manifest_path=str(root / "BENCHMARK.json"))
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1]), seen[0]


def test_a_traced_run_reports_every_program_metric(copy, capsys,
                                                   monkeypatch):
    res, record = _traced(copy, capsys, monkeypatch, 3000000041)
    assert res["correct"] is True
    got = res["metrics"]
    assert set(PROGRAM_METRICS) <= set(got)
    for name in PROGRAM_METRICS:
        assert got[name]["value"] >= 0.0
    # No escalation and no CUDA graph on the CPU.
    assert got["escalations.batch"]["value"] == 0.0
    assert got["capture_s.batch"]["value"] == 0.0
    # The stages lie inside the call: the certifier's four inside
    # certify_s.batch, which is the wrapper around the same function.
    stages = sum(got[n]["value"] for n in PROGRAM_METRICS[1:5])
    assert 0.0 < stages <= got["certify_s.batch"]["value"]
    calls = [c["spans"]["call"][0] for c in record["calls"]]
    assert got["assemble_s.batch"]["value"] < sum(calls) / len(calls)


@pytest.mark.parametrize("seed", [3000000043, 4000000019])
def test_escalations_agree_with_the_answers(copy, capsys, monkeypatch,
                                            seed):
    """Half the batch handed the other half's answers: those verdicts
    escalate, and the metric times the window's calls is the answers'
    ``escalated`` count."""
    res, record = _traced(copy, capsys, monkeypatch, seed, "half_batch")
    escalated = sum(int(np.sum(a["escalated"])) for a in record["answers"])
    assert escalated > 0
    per_call = res["metrics"]["escalations.batch"]["value"]
    assert round(per_call * len(record["calls"])) == escalated
    assert per_call * len(record["calls"]) == pytest.approx(escalated,
                                                            rel=1e-12)


def test_without_solve_records_the_readers_say_nothing(monkeypatch):
    from simplex_tpu_torch.utils import profiling

    record = {"calls": [{"spans": {}}]}
    monkeypatch.delattr(profiling, "recent")
    for name in PROGRAM_METRICS:
        assert registry.module("metrics", name).read(record) is None


def test_fewer_records_than_calls_say_nothing(monkeypatch):
    from simplex_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recent", lambda kind=None: [])
    record = {"calls": [{"spans": {}}] * 3}
    assert _program.window_records(record) is None
    assert _program.span_per_call(record, "certify.lapack") is None
    assert _program.count_per_call(record, "escalations") is None
    fake = [{"spans": [("certify.lapack", "batched.certify", 1.0, 1.5)],
             "counts": {"escalations": 2}}] * 4
    monkeypatch.setattr(profiling, "recent", lambda kind=None: fake)
    assert _program.span_per_call(record, "certify.lapack") == 0.5
    assert _program.span_per_call(record, "certify.gather") is None
    assert _program.count_per_call(record, "escalations") == 2.0
