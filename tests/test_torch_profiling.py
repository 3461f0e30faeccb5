"""``utils/profiling`` of the port against the JAX module, the solve
record the port's orchestrator logs against the JAX orchestrator's, and
the port's own spans, solve records and escalation counter."""
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import numpy as np

from _torch_parity import ANCHORS, CPU, anchor_wrapper, random_batch

import simplex_tpu.utils.profiling as j_prof
from simplex_tpu.controllers.orchestrator import \
    solve_problem_dict as j_solve_problem_dict
import simplex_tpu_torch.controllers.orchestrator as t_orch
import simplex_tpu_torch.models.certify as t_certify
import simplex_tpu_torch.models.dense as t_dense
import simplex_tpu_torch.utils.profiling as t_prof
from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.core.problem import LinearProgram
from simplex_tpu_torch.models.batched import BatchedSimplexSolver
from simplex_tpu_torch.parallel.sharded import solve_arrays_sharded

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

RECORDS = [
    dict(engine="dense", n_vars=2, n_cons=3, status=0, iterations=2,
         wall_s=0.0125),
    dict(engine="batched", n_vars=50, n_cons=30, status=0, iterations=27,
         wall_s=0.75, batch=16384, extra={"certified": True}),
    dict(engine="dense", n_vars=4, n_cons=2, status=2, iterations=5,
         wall_s=0.003),
]


@pytest.mark.parametrize("kw", RECORDS)
def test_solve_record_json_equals_the_jax_modules(kw):
    assert t_prof.SolveRecord(**kw).to_json() == \
        j_prof.SolveRecord(**kw).to_json()


def test_summary_equals_the_jax_modules():
    t_log, j_log = t_prof.MetricsLog(), j_prof.MetricsLog()
    assert t_log.summary() == j_log.summary() == {"solves": 0}
    for kw in RECORDS:
        t_log.log(t_prof.SolveRecord(**kw))
        j_log.log(j_prof.SolveRecord(**kw))
    assert t_log.summary() == j_log.summary()
    assert t_log.summary()["solves"] == 3 and t_log.summary()["optimal"] == 2


def test_jsonl_sink_writes_one_line_a_record(tmp_path):
    t_path, j_path = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    t_log, j_log = t_prof.MetricsLog(str(t_path)), j_prof.MetricsLog(str(j_path))
    for kw in RECORDS:
        t_log.log(t_prof.SolveRecord(**kw))
        j_log.log(j_prof.SolveRecord(**kw))
    lines = t_path.read_text().splitlines()
    assert len(lines) == len(RECORDS)
    assert [json.loads(line) for line in lines] == \
        [json.loads(t_prof.SolveRecord(**kw).to_json()) for kw in RECORDS]
    assert t_path.read_text() == j_path.read_text()


def test_default_metrics_reads_the_same_variable(tmp_path):
    path = str(tmp_path / "m.jsonl")
    code = ("from simplex_tpu_torch.utils import profiling\n"
            "print(profiling.DEFAULT_METRICS.path)\n")
    env = dict(os.environ, PYTHONPATH=REPO, SIMPLEX_TPU_METRICS_FILE=path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == path


def test_trace_span_counts_spans_and_annotates_the_profile(monkeypatch):
    monkeypatch.setattr(t_prof, "_SPANS", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with t_prof.trace_span("pivot_chain"):
                torch.ones(8).add_(1.0)
        with t_prof.trace_span("stream"):
            torch.ones(8).mul_(2.0)
    stats = t_prof.span_stats()
    assert {k: v["count"] for k, v in stats.items()} == \
        {"pivot_chain": 2, "stream": 1}
    assert all(v["total_s"] >= 0.0 and v["mean_ms"] >= 0.0
               for v in stats.values())
    keys = {e.key for e in prof.key_averages()}
    assert {"pivot_chain", "stream"} <= keys


@pytest.mark.parametrize("i", range(len(ANCHORS)))
def test_orchestrator_logs_the_jax_orchestrators_record(i, monkeypatch):
    t_log, j_log = t_prof.MetricsLog(), j_prof.MetricsLog()
    monkeypatch.setattr(t_orch, "DEFAULT_METRICS", t_log)
    monkeypatch.setattr(j_prof, "DEFAULT_METRICS", j_log)
    wrapper = anchor_wrapper(ANCHORS[i])
    j_solve_problem_dict(wrapper, save=False)
    t_orch.solve_problem_dict(wrapper, SolverConfig(device=CPU), save=False)
    assert len(t_log.records) == len(j_log.records) == 1
    got, ref = t_log.records[0], j_log.records[0]
    for name in ("engine", "n_vars", "n_cons", "status", "iterations",
                 "batch", "extra"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.engine == "dense" and got.status == 0
    assert got.wall_s > 0.0
    json.loads(got.to_json())


# The batched path's stages and the parent of each (the root's is None).
BATCHED_TREE = {
    "batched.solve_arrays": None,
    "batched.assemble": "batched.solve_arrays",
    "batched.run": "batched.solve_arrays",
    "graphs.read": "batched.run",
    "batched.certify": "batched.solve_arrays",
    "certify.gather": "batched.certify",
    "certify.lapack": "batched.certify",
    "certify.check": "batched.certify",
    "certify.escalate": "batched.certify",
}


def _solver(certify=True):
    return BatchedSimplexSolver(SolverConfig(device=CPU, dtype="float32",
                                             certify=certify))


def _solve_batch(seed, B=8):
    c, A, b, ops = random_batch(seed, B=B, m=5, n=7)
    return _solver().solve_arrays(c, A, b, ops, maximize=True)


def _nested(rec):
    """Each span lies inside its parent's interval (the latest span of
    the parent's name that opened before it)."""
    for name, parent, t0, t1 in rec["spans"]:
        assert t0 <= t1
        if parent is None:
            continue
        outer = [s for s in rec["spans"] if s[0] == parent and s[2] <= t0]
        assert outer, (name, parent)
        _, _, p0, p1 = max(outer, key=lambda s: s[2])
        assert p0 <= t0 and t1 <= p1, (name, parent)


def test_solve_arrays_opens_one_record_with_its_stages_nested():
    before = t_prof.recent("batched.solve_arrays")
    _solve_batch(11)
    after = t_prof.recent("batched.solve_arrays")
    rec = after[-1]
    assert rec not in before
    assert rec["kind"] == "batched.solve_arrays"
    assert rec["id"] > max((r["id"] for r in before), default=0)
    got = {name: parent for name, parent, _, _ in rec["spans"]}
    assert got == BATCHED_TREE
    # One of each stage, graphs.read once a chunk of the loop.
    names = [s[0] for s in rec["spans"]]
    assert all(names.count(n) == 1 for n in BATCHED_TREE if n !=
               "graphs.read")
    assert names[-1] == "batched.solve_arrays"      # the root closes last
    _nested(rec)
    assert rec["counts"].get("escalations", 0) == 0


def test_each_call_is_a_record_of_its_own():
    _solve_batch(12)
    _solve_batch(13)
    a, b = t_prof.recent("batched.solve_arrays")[-2:]
    assert a["id"] != b["id"]
    assert a["spans"][-1][3] <= b["spans"][-1][2]


def test_two_threads_solving_at_once_get_only_their_own_spans():
    """Threads solving at once with a short switch interval: every call is
    one record holding one of each of its stages, and the totals rise by
    the sum of the records' spans."""
    n_threads, calls = 4, 3
    names = [n for n in BATCHED_TREE if n != "graphs.read"]
    stats0 = t_prof.span_stats()
    ids0 = {r["id"] for r in t_prof.recent()}
    errors = []
    start = threading.Barrier(n_threads)

    def worker(i):
        try:
            start.wait(timeout=60)
            for k in range(calls):
                _solve_batch(100 + 10 * i + k, B=4 + i)
        except Exception as exc:          # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    mine = [r for r in t_prof.recent("batched.solve_arrays")
            if r["id"] not in ids0]
    assert len(mine) == n_threads * calls
    for rec in mine:
        got = [s[0] for s in rec["spans"]]
        assert all(got.count(n) == 1 for n in names), got
        _nested(rec)
    stats = t_prof.span_stats()
    for n in names:
        c0 = stats0.get(n, {"count": 0, "total_s": 0.0})
        assert stats[n]["count"] - c0["count"] == n_threads * calls
        spent = sum(t1 - t0 for rec in mine for name, _, t0, t1
                    in rec["spans"] if name == n)
        assert stats[n]["total_s"] - c0["total_s"] == \
            pytest.approx(spent, abs=2e-6)


def test_span_totals_and_the_ring_stay_bounded(monkeypatch):
    monkeypatch.setattr(t_prof, "_SPANS", {})
    for _ in range(10 ** 4):
        with t_prof.trace_span("many"):
            pass
    assert t_prof.span_stats()["many"]["count"] == 10 ** 4
    assert len(t_prof._SPANS) == 1 and len(t_prof._SPANS["many"]) == 2
    for _ in range(t_prof.RECORDS_KEPT + 10):
        with t_prof.solve_record("bounded.ring"):
            pass
    kept = t_prof.recent("bounded.ring")
    assert len(t_prof.recent()) == t_prof.RECORDS_KEPT
    assert len(kept) == t_prof.RECORDS_KEPT
    assert [r["id"] for r in kept] == sorted(r["id"] for r in kept)


def test_a_nested_record_is_a_span_of_the_outer_one():
    with t_prof.solve_record("outer") as outer:
        with t_prof.trace_span("stage"):
            with t_prof.solve_record("inner") as inner:
                t_prof.count("things", 2)
        t_prof.count("things")
    assert inner is outer
    assert [(n, p) for n, p, _, _ in outer["spans"]] == \
        [("inner", "stage"), ("stage", "outer"), ("outer", None)]
    assert outer["counts"] == {"things": 3}
    assert t_prof.recent("inner") == []
    assert t_prof.recent("outer")[-1] is outer


def test_a_span_outside_a_record_counts_in_the_totals_only():
    n0 = len(t_prof.recent())
    count0 = t_prof.span_stats().get("loose", {"count": 0})["count"]
    with t_prof.trace_span("loose"):
        t_prof.count("things")
    assert t_prof.span_stats()["loose"]["count"] == count0 + 1
    assert len(t_prof.recent()) == n0


def test_a_span_that_raises_is_kept_and_closes_its_record():
    with pytest.raises(ValueError):
        with t_prof.solve_record("raises"):
            with t_prof.trace_span("failing"):
                raise ValueError("stage failed")
    rec = t_prof.recent("raises")[-1]
    assert [(n, p) for n, p, _, _ in rec["spans"]] == \
        [("failing", "raises"), ("raises", None)]
    with t_prof.trace_span("after"):
        pass
    assert rec["spans"][-1][0] == "raises"       # no longer open


@pytest.mark.parametrize("k", [1, 3])
def test_escalations_count_every_escalated_instance(k):
    """A planted all-slack basis (x = 0, dual infeasible) in ``k``
    instances: the sweep certifier escalates exactly those, and
    ``ESCALATIONS`` and the record's count rise by ``k``."""
    c, A, b, ops = random_batch(21, B=6, m=5, n=7)
    res = _solver(certify=False).solve_arrays(c, A, b, ops, maximize=True)
    basis = np.array(res.basis)
    m, n = A.shape[1:]
    basis[:k, :m] = n + np.arange(m)
    before = t_certify.ESCALATIONS
    with t_prof.solve_record("planted") as rec:
        fix = t_certify.certify_sweep_le_f64(res.status, basis, c, A, b,
                                             True)
    assert fix["escalated"].tolist() == [True] * k + [False] * (6 - k)
    assert t_certify.ESCALATIONS - before == k
    assert rec["counts"] == {"escalations": k}
    assert fix["certified"].all()
    stages = [name for name, _, _, _ in rec["spans"]]
    assert stages == ["certify.gather", "certify.lapack", "certify.check",
                      "certify.escalate", "planted"]


def test_the_batched_record_counts_its_escalations(monkeypatch):
    """``solve_arrays`` with ``k`` verdicts the certifier cannot prove:
    the call's record counts them as its answers' ``escalated`` says."""
    from simplex_tpu_torch.models import batched as t_batched

    real = t_batched._run_batch

    def slack_basis(cb, config, *a, **kw):
        res = real(cb, config, *a, **kw)
        res.basis = np.array(res.basis)
        res.basis[:2, :5] = 7 + np.arange(5)
        return res

    monkeypatch.setattr(t_batched, "_run_batch", slack_basis)
    before = t_certify.ESCALATIONS
    res = _solve_batch(22, B=6)
    rec = t_prof.recent("batched.solve_arrays")[-1]
    assert int(res.escalated.sum()) == 2
    assert rec["counts"] == {"escalations": 2}
    assert t_certify.ESCALATIONS - before == 2


def test_each_stream_certificate_is_a_record_of_its_worker(monkeypatch):
    """``solve_arrays_stream`` certifies on a worker thread: each batch's
    certificate is a record of kind ``batched.certify`` with the stages
    nested under it and the escalations its answers name."""
    from simplex_tpu_torch.models import batched as t_batched

    real = t_batched._run_batch

    def slack_basis(cb, config, *a, **kw):
        res = real(cb, config, *a, **kw)
        res.basis = np.array(res.basis)
        res.basis[:2, :5] = 7 + np.arange(5)
        return res

    monkeypatch.setattr(t_batched, "_run_batch", slack_basis)
    batches = [random_batch(seed, B=6, m=5, n=7) for seed in (23, 24, 25)]
    before = t_certify.ESCALATIONS
    n_before = len(t_prof.recent("batched.certify"))
    cfg = SolverConfig(device=CPU, dtype="float32", certify=True)
    out = list(t_batched.solve_arrays_stream(iter(batches), cfg,
                                             maximize=True))
    recs = t_prof.recent("batched.certify")[n_before:]
    assert len(recs) == 3
    for rec, res in zip(recs, out):
        assert rec["counts"] == {"escalations": int(res.escalated.sum())}
        assert {n: p for n, p, _, _ in rec["spans"]} == {
            name: parent for name, parent in BATCHED_TREE.items()
            if parent == "batched.certify"} | {"batched.certify": None}
        _nested(rec)
    assert [int(r.escalated.sum()) for r in out] == [2, 2, 2]
    assert t_certify.ESCALATIONS - before == 6


def test_span_names_appear_in_a_cpu_profiler_session():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve_batch(14)
    keys = {e.key for e in prof.key_averages()}
    assert set(BATCHED_TREE) <= keys


def test_solve_lp_opens_a_record_with_its_stages():
    lp = LinearProgram(c=[15, 18], A=[[4, 2], [2, 6], [20, 28]],
                       b=[2000, 2400, 14000], ops=[-1, -1, -1],
                       maximize=True)
    res = t_dense.solve_lp(lp, SolverConfig(device=CPU))
    assert res.success and not res.escalated
    rec = t_prof.recent("dense.solve_lp")[-1]
    got = {(name, parent) for name, parent, _, _ in rec["spans"]}
    assert {("dense.solve_lp", None), ("dense.prepare", "dense.solve_lp"),
            ("dense.loop", "dense.solve_lp"), ("graphs.read", "dense.loop"),
            ("dense.finalize", "dense.solve_lp")} <= got
    assert "certify.escalate" not in {n for n, _ in got}
    _nested(rec)


def test_an_escalated_solve_lp_counts_one_escalation(monkeypatch):
    """A device verdict the float64 check rejects once: ``solve_lp``
    re-solves on the host under ``certify.escalate`` and counts it."""
    real = t_dense._finalize_on_host
    calls = []

    def reject_first(*args, **kw):
        calls.append(1)
        out = real(*args, **kw)
        return (False,) + tuple(out[1:]) if len(calls) == 1 else out

    monkeypatch.setattr(t_dense, "_finalize_on_host", reject_first)
    lp = LinearProgram(c=[15, 18], A=[[4, 2], [2, 6], [20, 28]],
                       b=[2000, 2400, 14000], ops=[-1, -1, -1],
                       maximize=True)
    before = t_certify.ESCALATIONS
    res = t_dense.solve_lp(lp, SolverConfig(device=CPU))
    assert res.escalated and res.success
    assert t_certify.ESCALATIONS - before == 1
    rec = t_prof.recent("dense.solve_lp")[-1]
    assert rec["counts"] == {"escalations": 1}
    assert ("certify.escalate", "dense.solve_lp") in \
        {(n, p) for n, p, _, _ in rec["spans"]}


def test_the_sharded_solve_keeps_its_span_names_under_its_root():
    c, A, b, ops = random_batch(15, B=3, m=6, n=5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = solve_arrays_sharded(c, A, b, ops, maximize=True,
                                   device=CPU)
    assert out["certified"].all()
    stages = ("sharded.assemble", "sharded.stage", "sharded.solve",
              "sharded.extract", "sharded.certify")
    assert set(stages) <= {e.key for e in prof.key_averages()}
    rec = t_prof.recent("sharded.solve_arrays")[-1]
    got = {(name, parent) for name, parent, _, _ in rec["spans"]}
    assert {(s, "sharded.solve_arrays") for s in stages} <= got
    _nested(rec)
