"""The ``mknapcb9.relax`` cell's own files: its manifest entries, the
generator of Chu & Beasley's law (``traffic/mknap.py``), the bounded
reference (``reference/bounded.py``) against HiGHS, the readers of its
per-layer metrics, and faults planted under a tiny copy of the cell that
its check must catch, on the CPU."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lpbench import faults, registry, roofline, run
from lpbench.metrics import _flip_roofline
from lpbench.reference import bounded
from lpbench.tests import _tiny
from lpbench.traffic import mknap

CELL = "mknapcb9.relax"
METRICS = ("k3_roofline.mknap", "run_s.mknap", "certify_s.mknap",
           "assemble_s.mknap", "flips.mknap", "device_idle.mknap")
BENCH = registry.manifest()
# Accepted metrics of the host certifier's stages and of the graph
# captures, whose lists take the cell as an append.
SHARED = ("certify_gather_s.batch", "certify_lapack_s.batch",
          "certify_check_s.batch", "escalate_s.batch", "escalations.batch",
          "capture_s.batch")


def _small(B=6, m=5, n=20, **kw):
    t = dict(registry.data("traffic", "mknap_relax"), batch=B, m=m, n=n,
             dtype="float32")
    t.update(kw)
    return t


def test_the_cell_and_its_metrics_are_additions():
    cell = registry.cell(CELL, BENCH)
    assert cell["entry"]["chips"] == 1
    assert cell["config"]["reduced"] == [] and cell["config"]["m"] == 30 \
        and cell["config"]["n"] == 500
    assert cell["traffic"]["batch"] == 16384 and cell["traffic"]["pool"] == 4
    assert {m["name"] for m in cell["end_to_end"]} == {"lp_rate", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(METRICS) | set(
        SHARED)
    for m in BENCH["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "lp_rate"
        if m["name"] in SHARED:
            assert m["workloads"] == ["batch30x50.classic", CELL]
    assert cell["workload"]["limits"]["at_upper_off"] == 0


def test_the_generator_draws_chu_and_beasleys_law():
    t = _small(B=40)
    it = mknap.item(t, 2**31 + 5, 3)
    A = it["A"].astype(np.int64)
    assert it["A"].dtype == np.float32 and A.min() >= 0 and A.max() <= 1000
    assert set(np.unique(it["alpha"])) <= {0.25, 0.5, 0.75}
    assert len(np.unique(it["alpha"])) == 3
    np.testing.assert_array_equal(
        it["b"], np.floor(it["alpha"][:, None] * A.sum(2)))
    q = (it["c"] - A.sum(1) / t["m"]) / t["profit_spread"]
    assert np.all(q > -1 / 500) and np.all(q < 1)
    np.testing.assert_array_equal(it["ub"], np.ones((40, t["n"])))
    again = mknap.item(t, 2**31 + 5, 3)
    for k in ("c", "A", "b", "alpha"):
        np.testing.assert_array_equal(it[k], again[k])
    other = mknap.item(t, 2**31 + 5, 4)
    assert not np.array_equal(it["A"], other["A"])
    # The pool's items, drawn on threads, are the items drawn one by one.
    pool = mknap.pool(t, 2**31 + 5)
    assert len(pool) == t["pool"]
    for k, drawn in enumerate(pool):
        alone = mknap.item(t, 2**31 + 5, k)
        for key in ("c", "A", "b", "ub", "alpha"):
            np.testing.assert_array_equal(drawn[key], alone[key])


def test_the_bounded_reference_agrees_with_highs():
    from scipy.optimize import linprog

    it = mknap.item(_small(B=4, m=6, n=30), 17, 0)
    ref = bounded.solve(it["c"], it["A"], it["b"], it["ub"])
    assert np.all(ref["status"] == 0)
    for i in range(4):
        h = linprog(-it["c"][i].astype(float), A_ub=it["A"][i].astype(float),
                    b_ub=it["b"][i].astype(float), bounds=[(0, 1)] * 30,
                    method="highs")
        assert abs(-h.fun - ref["z"][i]) <= 1e-9 * abs(h.fun)
        np.testing.assert_allclose(ref["y"][i], -h.ineqlin.marginals,
                                   atol=1e-7 * abs(h.fun))


def test_flip_bytes_compose_the_kept_helpers():
    pivots = np.array([0, 3, 7, 7, 12, 1])
    M, N, L = 32, 640, 14
    none = np.zeros_like(pivots)
    # Without flips, the kept reader's bytes.
    assert _flip_roofline.solve_bytes(M, N, 4, pivots, none, L) == \
        roofline.batched_solve_bytes(M, N, 4, pivots, L, True)
    flips = np.array([0, 1, 5, 0, 6, 1])
    got, flops = _flip_roofline.solve_bytes(M, N, 4, pivots, flips, L)
    kept, kept_flops = roofline.batched_solve_bytes(M, N, 4, pivots, L,
                                                    True)
    assert got < kept and flops == 2 * M * N * int((pivots - flips).sum())
    # A flip costs its instance what a stopping step costs, plus the RHS
    # column written and at_upper[s]: N + 3M elements and a byte.
    one = _flip_roofline.solve_bytes(M, N, 4, [1], [1], 1)[0]
    stop = _flip_roofline.solve_bytes(M, N, 4, [0], [0], 1)[0]
    assert one - stop == 4 * M + 1


def _record(notes, kernels, traced=True):
    return {"label": "batch", "calls": [{"spans": {}, "notes": notes,
                                         "traced": traced}],
            "profile": {"kernels": kernels, "busy_s": 1.0, "window_s": 4.0},
            "window_s": 4.0}


def test_the_roofline_reader():
    read = registry.module("metrics", "k3_roofline.mknap").read
    notes = {"tableau": (6, 32, 640, 4), "pivots": np.array([0, 3, 7, 7]),
             "flips": np.array([0, 1, 2, 0]), "bounded": True,
             "launches": 8}
    nbytes, flops = _flip_roofline.solve_bytes(32, 640, 4, notes["pivots"],
                                               notes["flips"], 8)
    bound = roofline.bound_s(nbytes, flops)[0]
    kernel = "void (anonymous namespace)::fused_pivot_step_bounded_kernel<"
    got = read(_record(notes, {kernel + "float>(...)": 4 * bound}))
    assert got == pytest.approx(25.0)
    # The float64 finish's launches are not the loop's: their time is left
    # out, as their steps are.
    got = read(_record(notes, {kernel + "float>(...)": 4 * bound,
                               kernel + "double>(...)": 9.0}))
    assert got == pytest.approx(25.0)
    # A program whose loop does not count flips (the note lacks them), an
    # untraced call, no K3 time: nothing to read.
    old = {k: v for k, v in notes.items() if k != "flips"}
    assert read(_record(old, {kernel: 1.0})) is None
    assert read(_record(notes, {kernel: 1.0}, traced=False)) is None
    assert read(_record(notes, {"other_kernel": 1.0})) is None
    idle = registry.module("metrics", "device_idle.mknap").read
    assert idle(_record(notes, {})) == pytest.approx(75.0)


def test_the_flip_counter_reader_reads_nothing_without_the_count(
        monkeypatch):
    from simplex_tpu_torch.utils import profiling

    read = registry.module("metrics", "flips.mknap").read
    record = {"calls": [{}, {}]}
    recs = [{"counts": {"escalations": 0}}] * 2
    monkeypatch.setattr(profiling, "recent", lambda kind=None: recs)
    assert read(record) is None
    recs = [{"counts": {"bound_flips": 10}}, {"counts": {"bound_flips": 30}}]
    assert read(record) == 20.0


# ---------------------------------------------------------------------------
# A tiny copy of the cell, run on the CPU.


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("mknap")
    lp = _tiny.make(str(root))
    c = registry.data("configs", "mknapcb9")
    c.update(name="tinymknap", m=5, n=40)
    t = dict(registry.data("traffic", "mknap_relax"), batch=16, pool=2)
    for kind, name, d in (("configs", "tinymknap", c),
                          ("traffic", "tiny_mknap", t)):
        with open(os.path.join(lp, kind, name + ".json"), "w") as f:
            json.dump(d, f)
    shutil.copy(os.path.join(lp, "workloads", CELL + ".json"),
                os.path.join(lp, "workloads", "tiny.mknap.json"))
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.mknap", "config": "tinymknap",
                               "traffic": "tiny_mknap", "chips": 1,
                               "why": "a CPU test's copy of " + CELL})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.mknap")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root, lp


def _run(copy, capsys, monkeypatch, trace=0):
    root, lp = copy
    monkeypatch.setattr(registry, "ROOT", lp)
    rc = run.main(["--workload", "tiny.mknap", "--seed", "3000000023",
                   "--seconds", "0.01", "--trace", str(trace), "--device",
                   "cpu"], manifest_path=str(root / "BENCHMARK.json"))
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1])


def _failed(res):
    return {k for k, (v, lim) in res["checks"].items()
            if v is None or v > lim}


def test_without_a_fault_the_tiny_cell_is_correct(copy, capsys,
                                                   monkeypatch):
    res = _run(copy, capsys, monkeypatch)
    assert res["correct"] is True and res["attempted"] >= 16
    assert set(res["metrics"]) == {"lp_rate", "setup_s"}
    traced = _run(copy, capsys, monkeypatch, trace=1)
    assert traced["correct"] is True
    # On the CPU no device trace: the program's spans and counters only.
    assert {"run_s.mknap", "certify_s.mknap", "assemble_s.mknap",
            "flips.mknap"} <= set(traced["metrics"])
    assert traced["metrics"]["flips.mknap"]["value"] > 0


def _wrap_answers(monkeypatch, alter):
    from simplex_tpu_torch.models import batched

    real = batched.BatchedSimplexSolver.solve_arrays

    def solve_arrays(self, *args, **kw):
        res = real(self, *args, **kw)
        half = len(res.status) // 2
        alter(res, half)
        return res

    monkeypatch.setattr(batched.BatchedSimplexSolver, "solve_arrays",
                        solve_arrays)


def _flip_at_upper(res, half):
    n = res.x.shape[1]
    res.at_upper = np.array(res.at_upper)
    res.at_upper[:half, :n] = ~res.at_upper[:half, :n]


def _off_objective(res, half):
    res.z = np.array(res.z)
    res.z[:half] *= 1.01


@pytest.mark.parametrize("alter,check", [(_flip_at_upper, "at_upper_off"),
                                         (_off_objective, "z_gap")])
def test_a_half_batch_fault_makes_the_run_not_correct(copy, capsys,
                                                      monkeypatch, alter,
                                                      check):
    _wrap_answers(monkeypatch, alter)
    res = _run(copy, capsys, monkeypatch)
    assert res["correct"] is False and check in _failed(res)


@pytest.mark.parametrize("kind", ["step_noop", "half_batch", "alter_answer"])
def test_the_kept_faults_make_the_run_not_correct(copy, capsys, monkeypatch,
                                                  kind):
    with faults.planted(kind):
        res = _run(copy, capsys, monkeypatch)
    assert res["correct"] is False and _failed(res)


def test_the_calibration_reads_the_cell_through_its_entry(copy):
    root, _ = copy
    out = subprocess.run(
        [sys.executable, "-m", "lpbench.entries.mknap_relax", "--workload",
         "tiny.mknap", "--seeds", "3000000031", "--control-seeds",
         "3000000037", "--device", "cpu"], cwd=root, env=_tiny.env(),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["kind"] for x in lines] == ["program", "control"]
    prog, ctl = lines[0]["readings"], lines[1]["readings"]
    assert prog["status_mismatch"] == 0 and prog["z_gap"] < 1e-9
    assert ctl["z_gap"] > prog["z_gap"]
