"""``utils/profiling`` of the port against the JAX module, and the solve
record the port's orchestrator logs against the JAX orchestrator's."""
import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import ANCHORS, CPU, anchor_wrapper

import simplex_tpu.utils.profiling as j_prof
from simplex_tpu.controllers.orchestrator import \
    solve_problem_dict as j_solve_problem_dict
import simplex_tpu_torch.controllers.orchestrator as t_orch
import simplex_tpu_torch.utils.profiling as t_prof
from simplex_tpu_torch.config import SolverConfig

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


def test_simple_timeit_returns_the_mean_and_the_count():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1.0

    out = t_prof.simple_timeit(fn, torch.ones(4), iters=5, warmup=2)
    assert set(out) == {"mean_s", "iters"}
    assert out["iters"] == 5 and out["mean_s"] >= 0.0
    assert len(calls) == 7
    with pytest.raises(ValueError):
        t_prof.simple_timeit(fn, torch.ones(4), iters=1, warmup=0)


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
