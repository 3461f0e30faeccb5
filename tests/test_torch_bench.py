"""The port's measurement runner against the repo's ``bench.py``.

``simplex_tpu_torch/bench.py`` (``python -m simplex_tpu_torch.bench``) and
its cells (``utils/pivot_bench.py``, ``utils/solve_bench.py``,
``utils/sweep_bench.py``) at small sizes on the CPU, where the kernels'
plain twins run, against bench.py's functions at the same sizes on JAX's
CPU.  Both sides generate their inputs from the same seeds; the tests
catch the inputs each side hands its solver and hold them equal.  Held:

* the same ``metric`` and ``unit``, and ``detail``'s keys: bench.py's,
  plus the port's documented additions (:data:`ADDED`);
* the simplex cells (batched, bounded, dense, exact stream): the same
  statuses, optimal counts and ``vs_baseline``, and z within
  1e-6·(1+|z|);
* PDHG and its stream: the same converged share, with JAX's power-
  iteration start vector in the port (as ``tests/test_torch_pdhg.py``
  holds the float32 loops: its ``converged`` flags equal);
* ``main()``: one JSON line for each mode with ``--device cpu``, and an
  error without a GPU when ``--device`` is left at ``cuda``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
import simplex_tpu.models.batched as j_mb
import simplex_tpu.ops.batched as j_ob

from _torch_parity import z_close

from simplex_tpu_torch import bench as port_bench
from simplex_tpu_torch.models import batched as t_mb
from simplex_tpu_torch.models import pdhg as t_pdhg
from simplex_tpu_torch.ops import batched as t_ob
from simplex_tpu_torch.utils import pivot_bench, solve_bench, sweep_bench

CPU = "cpu"

# Keys the port's ``detail`` adds to bench.py's, by cell.
ADDED = {
    "batched": {"first_solve_s", "rep_s", "device"},
    "bounded": {"first_solve_s", "rep_s", "device", "backend"},
    "dense": {"first_solve_s", "device"},
    "pdhg": {"first_solve_s", "rep_s", "device"},
    "stream": {"device"},
    "stream_exact": {"warmup_s", "device"},
}


def _same_shape(port, ref, cell):
    assert port["metric"] == ref["metric"] and port["unit"] == ref["unit"]
    assert set(port["detail"]) == set(ref["detail"]) | ADDED[cell]
    assert not set(ref["detail"]) & ADDED[cell]


def _spy(monkeypatch, owner, name, calls):
    """Record each call of ``owner.name``: its arguments and its result."""
    fn = getattr(owner, name)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(owner, name, spy)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_batched_cell_matches_bench_py(monkeypatch):
    ref_calls, port_calls = [], []
    _spy(monkeypatch, j_mb.BatchedSimplexSolver, "solve_arrays", ref_calls)
    _spy(monkeypatch, t_mb.BatchedSimplexSolver, "solve_arrays", port_calls)
    ref = ref_bench.bench_batched_solve(B=32, reps=2)
    port = solve_bench.bench_batched_solve(B=32, reps=2, device=CPU)
    _same_shape(port, ref, "batched")
    (r_args, _, r_res), (p_args, _, p_res) = ref_calls[-1], port_calls[-1]
    for a, b in zip(r_args[1:5], p_args[1:5]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p_res.status, r_res.status)
    np.testing.assert_array_equal(p_res.certified, r_res.certified)
    ok = r_res.status == 0
    assert all(z_close(a, b) for a, b in zip(r_res.z[ok], p_res.z[ok]))
    assert port["vs_baseline"] == ref["vs_baseline"] == 1.0
    d = port["detail"]
    assert d["n_optimal"] == ref["detail"]["n_optimal"] == 32
    assert d["backend"] == "K2 twin" and d["n_reps"] == 2
    assert len(d["rep_s"]) == 2 and d["first_solve_s"] > 0
    assert port["value"] == pytest.approx(32 / d["device_solve_s"])


def test_bounded_cell_matches_bench_py(monkeypatch):
    calls = {k: [] for k in ("rc", "pc", "rs", "ps")}
    _spy(monkeypatch, j_mb, "compile_batch_on_device", calls["rc"])
    _spy(monkeypatch, solve_bench, "compile_batch_on_device", calls["pc"])
    _spy(monkeypatch, j_ob, "solve_tableau_batch_bounded", calls["rs"])
    _spy(monkeypatch, solve_bench, "solve_tableau_batch_bounded",
         calls["ps"])
    ref = ref_bench.bench_bounded_batched(B=32, reps=2)
    port = solve_bench.bench_bounded_batched(B=32, reps=2, device=CPU)
    _same_shape(port, ref, "bounded")
    (r_args, r_kw, _), (p_args, p_kw, _) = calls["rc"][0], calls["pc"][0]
    for a, b in zip(r_args[:4] + (r_kw["ub"],), p_args[:4] + (p_kw["ub"],)):
        np.testing.assert_array_equal(a, b)
    # The first (warm-up) solve of each: statuses and z.
    r_in, _, r_out = calls["rs"][0]
    _, p_kw, p_out = calls["ps"][0]
    np.testing.assert_array_equal(_np(p_out[3]), _np(r_out[3]))
    _, z_ref = j_ob.extract_solution_batch_bounded(
        r_out[0], r_out[1], r_out[2], r_in[7], 50)
    _, z = t_ob.extract_solution_batch_bounded(
        p_out[0], p_out[1], p_out[2], p_kw["ub"], 50)
    assert all(z_close(float(a), float(b))
               for a, b in zip(_np(z_ref), _np(z)))
    assert port["vs_baseline"] == ref["vs_baseline"] == 1.0
    assert port["detail"]["n_optimal"] == ref["detail"]["n_optimal"]
    assert port["detail"]["backend"] == "K3 twin"


def test_dense_cell_matches_bench_py():
    ref = ref_bench.bench_dense_solve(48)
    port = solve_bench.bench_dense_solve(48, device=CPU)
    _same_shape(port, ref, "dense")
    d, rd = port["detail"], ref["detail"]
    assert d["status"] == rd["status"] == 0
    assert port["vs_baseline"] == ref["vs_baseline"] == 1.0
    assert z_close(rd["z"], d["z"])
    assert port["value"] == pytest.approx(d["pivots"] / d["wall_s"])


@pytest.fixture
def jax_start(monkeypatch):
    """The port's PDHG power iteration starts from JAX's draw
    (``tests/test_torch_pdhg.py``)."""
    def draw(B, n, dtype, device):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = jax.random.normal(jax.random.PRNGKey(0), (B, n), dtype=jdt)
        return torch.as_tensor(np.array(v), device=device)

    monkeypatch.setattr(t_pdhg, "_power_iter_start", draw)


def test_pdhg_cell_matches_bench_py(jax_start):
    ref = ref_bench.bench_pdhg(B=16, reps=1)
    port = sweep_bench.bench_pdhg(B=16, reps=1, device=CPU)
    _same_shape(port, ref, "pdhg")
    assert port["detail"]["converged"] == ref["detail"]["converged"] >= 12
    assert port["vs_baseline"] == ref["vs_baseline"]
    assert port["detail"]["pdhg_iters"] == ref["detail"]["pdhg_iters"]


def test_stream_cell_matches_bench_py(jax_start):
    """Two chunks of 64: every instance converged or recovered on both
    sides, the same instances recovered."""
    ref = ref_bench.bench_stream(total=128, chunk=64)
    port = sweep_bench.bench_stream(total=128, chunk=64, device=CPU)
    _same_shape(port, ref, "stream")
    d, rd = port["detail"], ref["detail"]
    assert d["chunks"] == rd["chunks"] == 2 and len(d["chunk_wall_s"]) == 2
    for k in ("converged", "exact_recovered", "converged_frac"):
        assert d[k] == rd[k], k
    assert d["converged_frac"] == 1.0
    assert port["vs_baseline"] == pytest.approx(d["wall_s"]
                                                / d["device_solve_s"])


def test_stream_exact_cell_matches_bench_py():
    ref = ref_bench.bench_stream_exact(total=128, chunk=64)
    port = sweep_bench.bench_stream_exact(total=128, chunk=64, device=CPU)
    _same_shape(port, ref, "stream_exact")
    d, rd = port["detail"], ref["detail"]
    for k in ("chunks", "chunk_size", "optimal", "certified",
              "certified_frac", "escalated"):
        assert d[k] == rd[k], k
    assert port["vs_baseline"] == ref["vs_baseline"] == 1.0
    assert d["engine"].startswith("batched simplex (K2 twin)")


def test_pivot_rate_sub_benches_match_bench_py(monkeypatch):
    """The default mode's four batched sub-benches, their sizes cut to
    B=16 on both sides: bench.py's keys (``pallas_*`` are ``k4_*`` in the
    port, which also adds each stream's spread and ``bounded_backend``),
    equal optimal counts."""
    for mod in (ref_bench, solve_bench):
        for name in ("bench_batched_solve", "bench_bounded_batched"):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name,
                                lambda B=1024, fn=fn, **kw: fn(B=16, **kw))
    ref = ref_bench.bench_pivot_update(48, 3, reps=2)
    port = pivot_bench.bench_pivot_update(48, 3, reps=2, device=CPU)
    assert port["metric"] == ref["metric"] and port["unit"] == ref["unit"]
    renamed = {k.replace("pallas_", "k4_") for k in ref["detail"]}
    assert set(port["detail"]) == renamed | {
        "outofplace_spread", "k4_stream_spread", "k4_outofplace_spread",
        "bounded_backend"}
    d, rd = port["detail"], ref["detail"]
    assert d["batched_n_optimal"] == rd["batched_n_optimal"] == 16
    assert d["bounded_n_optimal"] == rd["bounded_n_optimal"] == 16
    assert (d["batched_backend"], d["bounded_backend"]) == ("K2 twin",
                                                            "K3 twin")
    for k in ("batched_lps_per_sec", "bounded_lps_per_sec",
              "batched_lps_per_sec_16k", "bounded_lps_per_sec_16k"):
        assert d[k] > 0, k


# Each mode of main() at a small size on the CPU: its flags and the
# metric its line names.
MODES = {
    "pivot": (["--size", "32", "--iters", "3", "--reps", "1",
               "--no-batched-detail"], "pivots_per_sec_32x32_f32"),
    "batch": (["--batch", "--batch-size", "16", "--reps", "1"],
              "batched_lps_per_sec_16x30x50"),
    "pdhg": (["--pdhg", "--batch-size", "8", "--reps", "1"],
             "pdhg_lps_per_sec_8x20x30"),
    "solve-dense": (["--solve-dense", "--size", "40"],
                    "dense_solve_pivots_per_sec_40x40"),
    "sharded": (["--sharded", "--size", "40", "--iters", "4", "--reps", "1"],
                "sharded_pivots_per_sec_40x40_f32"),
    "stream": (["--stream", "--stream-total", "32"],
               "stream_end_to_end_lps_per_sec_32"),
    "stream-exact": (["--stream-exact", "--stream-total", "32"],
                     "stream_exact_certified_lps_per_sec_32"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_main_prints_one_json_line_a_mode(mode, capsys):
    flags, metric = MODES[mode]
    rec = port_bench.main(flags + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == list(port_bench.KEYS) and line["metric"] == metric
    assert line["metric"] == rec["metric"] and line["value"] > 0
    # On the CPU the twins run, so no kernel counts a launch.
    assert line["detail"]["launches"] == {"K1": 0, "K2": 0, "K3": 0,
                                          "K4": 0}


def test_main_keeps_bench_py_size_rules(monkeypatch):
    """--solve-dense at 2048 unless --size is given, --stream-exact at 16 x
    65,536 for the default total, --sharded compared at min(8192, size),
    and --batch / --pdhg at 1024 / 65,536 instances by default."""
    seen = []
    for mod, name in ((solve_bench, "bench_dense_solve"),
                      (solve_bench, "bench_batched_solve"),
                      (sweep_bench, "bench_pdhg"),
                      (sweep_bench, "bench_stream_exact"),
                      (sweep_bench, "bench_stream")):
        monkeypatch.setattr(mod, name, lambda *a, name=name, **kw:
                            seen.append((name, a, kw)))
    from simplex_tpu_torch.utils import sharded_bench

    monkeypatch.setattr(sharded_bench, "bench_sharded", lambda *a, **kw:
                        seen.append(("bench_sharded", a, kw)))
    cpu = ["--device", "cpu"]
    for flags in (["--solve-dense"], ["--solve-dense", "--size", "512"],
                  ["--batch"], ["--pdhg"], ["--stream-exact"],
                  ["--stream"], ["--sharded", "--size", "10240"],
                  ["--sharded", "--size", "4096"]):
        port_bench.run(port_bench.parser().parse_args(flags + cpu))
    got = [(n, a, {k: v for k, v in kw.items() if k != "device"})
           for n, a, kw in seen]
    assert got == [
        ("bench_dense_solve", (2048,), {}),
        ("bench_dense_solve", (512,), {}),
        ("bench_batched_solve", (), {"B": 1024, "reps": 5}),
        ("bench_pdhg", (), {"B": 65536, "reps": 5}),
        ("bench_stream_exact", (), {"total": 1_048_576, "chunk": 65536}),
        ("bench_stream", (), {"total": 1_000_000, "chunk": 250_000}),
        ("bench_sharded", (10240, 64), {"reps": 3, "compare_size": 8192}),
        ("bench_sharded", (4096, 64), {"reps": 3, "compare_size": 4096}),
    ]


def test_main_asks_for_the_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for flags in ([], ["--batch"], ["--stream-exact"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_bench.main(flags)
    assert capsys.readouterr().out == ""
