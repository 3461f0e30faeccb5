"""Tiny cells end to end on the CPU: the result line, the checks
on standard error, and the refusals."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lpbench.tests import _tiny
from lpbench.traffic import generate


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    _tiny.make(str(root))
    return root


def _run(root, cell, trace, device="cpu", seed=3000000019, seconds=0.5):
    cmd = [sys.executable, "-m", "lpbench.run", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    if device:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=root, env=_tiny.env(),
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(_tiny.TINY))
def test_a_tiny_cell_prints_its_result_line(copy, cell, trace):
    out = _run(copy, cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    res = _tiny.last_json(out.stdout)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    assert dev["count"] == 1 and "memory_peak_bytes" in dev
    bench = json.load(open(copy / "BENCHMARK.json"))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # Host spans are read on the CPU; device numbers are not.
        assert not any("roofline" in k or "idle" in k
                       for k in res["metrics"])
    else:
        assert set(res["metrics"]) == want
    # The numbers compared close standard error, each beside its limit.
    tail = out.stderr.strip().splitlines()[-len(res["checks"]):]
    for line, (name, (value, limit)) in zip(tail, res["checks"].items()):
        assert line == f"[check] {name} {value!r} limit {limit!r}"


def test_no_card_no_result(copy):
    out = _run(copy, "tiny.classic", 0, device=None)
    assert out.returncode != 0 and not out.stdout.strip()


def test_without_the_port_no_result(tmp_path):
    root = tmp_path / "alone"
    root.mkdir()
    _tiny.make(str(root))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", "tiny.classic",
         "--seed", "1", "--seconds", "0.2", "--trace", "0", "--device",
         "cpu"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_same_seed_gives_the_same_inputs():
    t = dict(json.load(open(os.path.join(
        os.path.dirname(generate.__file__), "bounded.json"))),
        batch=8, m=30, n=50, dtype="float32")
    seed = 2 ** 31 + 12345
    a, b = generate.item(t, seed, 1), generate.item(t, seed, 1)
    for k in ("c", "A", "b", "ub"):
        np.testing.assert_array_equal(a[k], b[k])
    other = generate.item(t, seed + 1, 1)
    assert not np.array_equal(a["A"], other["A"])
    assert a["A"].shape == other["A"].shape
    assert a["A"].dtype == np.float32
    share = np.isfinite(generate.item(dict(t, batch=2000), 3, 0)["ub"]).mean()
    assert 0.57 < share < 0.63


def test_the_generator_draws_the_ports_law():
    """Seeded like ``utils/solve_bench.lp_batch`` and ``dense_lp`` (seed 0),
    the generator draws the same arrays in the same order."""
    from simplex_tpu_torch.utils import solve_bench

    rng = np.random.default_rng(0)
    t = {"batch": 16, "m": 30, "n": 50, "dtype": "float32",
         "A": [0.05, 1.0], "b": {"uniform": [1.0, 5.0]}, "c": [0.1, 1.0],
         "ub": {"share": 0.6, "range": [1.0, 3.0]}}
    orig = generate.np.random.default_rng
    try:
        generate.np.random.default_rng = lambda s: rng
        mine = generate.item(t, 0, 0)
    finally:
        generate.np.random.default_rng = orig
    c, A, b, _, ub = solve_bench.lp_batch(16, bounded=True)
    for x, y in ((mine["c"], c), (mine["A"], A), (mine["b"], b),
                 (mine["ub"], ub)):
        np.testing.assert_array_equal(x, y)
