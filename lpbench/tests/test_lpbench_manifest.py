"""``BENCHMARK.json`` against the benchmark's rules, and every part of
every cell found by its name."""
import json
import os
import re
import statistics
import subprocess
import sys

import pytest

from lpbench import registry
from lpbench.tests import _tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
BENCH = registry.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its budget of 43,200 s.
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_workloads_and_metrics():
    names = {c["name"] for c in BENCH["configs"]}
    assert len(names) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert names == used
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert c["file"].startswith("lpbench/") and c["file"] not in files
        files.add(c["file"])
        assert os.path.isfile(os.path.join(_tiny.REPO, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(_tiny.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] \
                or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    c = registry.cell(cell, BENCH)
    assert {"setup_s"} < {m["name"] for m in c["end_to_end"]}
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert m["moves"] in {e["name"] for e in c["end_to_end"]}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)
    entry = registry.module("entries", c["workload"]["entry"])
    assert callable(entry.make) and entry.LABEL
    assert c["workload"]["limits"]


def test_a_name_cannot_leave_its_folder():
    with pytest.raises(ValueError):
        registry.path("configs", "../BENCHMARK", ".json")


def test_files_added_by_name_are_picked_up(tmp_path):
    """A new configuration, traffic mix, workload and per-layer metric,
    each a file of its own plus its manifest entry, reach a run of the
    copy without an edit to any file the benchmark had."""
    lp = _tiny.make(str(tmp_path))
    with open(os.path.join(lp, "metrics", "calls.tiny.py"), "w") as f:
        f.write("def read(record):\n    return len(record['calls'])\n")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["per_layer"].append({
        "name": "calls.tiny", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "lp_rate",
        "workloads": ["tiny.classic"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    out = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", "tiny.classic",
         "--seed", "4000000007", "--seconds", "0.5", "--trace", "1",
         "--device", "cpu"], cwd=tmp_path, env=_tiny.env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = _tiny.last_json(out.stdout)
    assert res["metrics"]["calls.tiny"]["value"] >= 1
    assert res["correct"] is True


def test_spread_is_statistics_quantiles():
    # The bound's spread: (Q3 - Q1) / median by statistics.quantiles.
    vals = [10.0, 10.2, 9.9, 10.1, 10.05, 9.95]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert 0 < (q3 - q1) / statistics.median(vals) < 0.03
