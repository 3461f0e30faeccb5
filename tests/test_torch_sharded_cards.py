"""The runner of row-sharded solves across cards
(``python -m simplex_tpu_torch.utils.sharded_cards``) on four gloo ranks.

One run of the runner (``--device cpu --ranks 4``) covers phases (a) to
(d) at small sizes: the collectives over the world and the row groups of a
(2, 2) mesh, the loop on (1, 4), the layouts (1, 4), (2, 2) and (4, 1) on
the LPs of ``_torch_sharded_worker`` and config 5's generator cut to 512
rows, and config 5 at 512 rows.  Each layout's float64 solve, which rank 0
writes out (``--out``), is held step-equal to the JAX
``solve_tableau_sharded`` on the same mesh of the eight virtual devices
conftest gives this process.  The failure cases: a worker that fails, a
time limit, and CUDA asked for where there is no card.  The ``gpu`` case
runs on four cards alone (it imports no JAX):

    python -m pytest tests/test_torch_sharded_cards.py -m gpu --noconftest
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_sharded_worker as worker

from simplex_tpu_torch.parallel import sharded as ps
from simplex_tpu_torch.utils import sharded_cards as sc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = [(1, 4), (2, 2), (4, 1)]


def _lps():
    lps = {name: sc._lp(**make()) for name, make in worker.CASES.items()}
    lps["config5_512"] = sc._lp(*sc.config5_lp(512), True, max_iters=512)
    return lps


def _run_cards(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo")
    env.pop("SIMPLEX_TPU_COORDINATOR", None)
    return subprocess.run(
        [sys.executable, "-m", "simplex_tpu_torch.utils.sharded_cards",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def _lines(stdout, tag):
    return [json.loads(line[len(tag) + 1:]) for line in stdout.splitlines()
            if line.startswith(tag + " ")]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_cards")
    sc.save_lps(tmp / "lps.npz", _lps())
    out = _run_cards("--device", "cpu", "--ranks", "4", "--lps",
                  str(tmp / "lps.npz"), "--out", str(tmp / "out"),
                  "--rows", "512", "--cut-rows", "256", "--timeout", "200")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return tmp / "out", _lines(out.stdout, "[check]"), \
        _lines(out.stdout, "[summary]")


def test_the_run_prints_one_line_a_check_then_its_summary(four_ranks):
    _, checks, summary = four_ranks
    assert len(summary) == 1 and summary[0]["ok"]
    assert summary[0]["ranks"] == 4 and summary[0]["checks"] == len(checks)
    assert all(c["ok"] for c in checks)
    # (a) 4 collectives at 2 sizes over the world and the (2,2) row group,
    # eager and graph on one line, the WHILE body on another,
    # (b) and (c) the 5 LPs (on 1 and 3 layouts), (d) two gated solves,
    # each rank's memory twice and each rank's eager chunk once.
    phases = [c["phase"] for c in checks]
    assert [phases.count(p) for p in "abcd"] == [32, 5, 15, 14]


def test_every_collective_equals_the_hosts_in_each_mode(four_ranks):
    _, checks, _ = four_ranks
    names = [c["check"] for c in checks if c["phase"] == "a"]
    for kind in ("min", "max", "sum", "gather"):
        for group in ("the world (4 ranks)", "the row group of (2,2) "
                                             "(2 ranks)"):
            lines = [n for n in names if f"{kind} over {group}" in n]
            assert len(lines) == 4
            assert sum("WHILE body" in n for n in lines) == 2


def test_the_loop_takes_one_step_an_iteration_on_every_rank(four_ranks):
    _, checks, _ = four_ranks
    for c in (c for c in checks if c["phase"] == "b"):
        assert c["steps"] == [c["iters"]] * 3, c
        assert c["bit_equal"] and c["flags_equal"], c


def test_config5_at_512_rows_is_certified_within_the_gate(four_ranks):
    _, checks, _ = four_ranks
    gated = [c for c in checks if c["phase"] == "d" and "z_highs" in c]
    assert len(gated) == 2
    for c in gated:
        assert abs(c["z"] - c["z_highs"]) <= 1e-6 * (1 + abs(c["z_highs"]))
    assert gated[0]["steps"] == gated[0]["iters"]
    memory = [c for c in checks if "peak_host_rss_gib" in c]
    assert sorted(c["rank"] for c in memory) == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("name", sorted(_lps()))
@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_layout_is_step_equal_to_the_reference(four_ranks, shape, name):
    """Float64, a resync every 64 steps (the runner's defaults)."""
    import jax
    import jax.numpy as jnp

    from simplex_tpu.parallel import sharded as js

    out_dir, _, _ = four_ranks
    lp = _lps()[name]
    got = np.load(out_dir / f"{shape[0]}x{shape[1]}_{name}.npz")
    _, arrays, bounded = ps.compile_sharded(
        lp["c"], lp["A"], lp["b"], lp["ops"], lp["maximize"], *shape,
        dtype=np.float64, ub=lp["ub"])
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in js.solve_tableau_sharded(
            *[jnp.asarray(a) for a in arrays], mesh=js.make_mesh(*shape),
            max_iters=lp["max_iters"], bounded=bounded)]
    np.testing.assert_array_equal(ref[3], got["status"])
    assert int(ref[4]) == int(got["iters"])
    np.testing.assert_array_equal(ref[1], got["basis"])
    np.testing.assert_array_equal(ref[5], got["at_upper"])
    z_ref, z = ref[2][:, -1], got["obj"][:, -1]
    assert np.all(np.abs(z - z_ref) <= 1e-9 * (1.0 + np.abs(z_ref)))
    # The float32 solve: the gate against the float64 reference (whose
    # objective cell holds -z_min).
    ok = got["f32_status"] == 0
    z64 = np.where(lp["maximize"], z_ref, -z_ref)[:len(ok)]
    assert np.all(np.abs(got["f32_z"][ok] - z64[ok])
                  <= 1e-6 * (1.0 + np.abs(z64[ok])))


def test_a_failing_worker_stops_every_rank_and_is_named(tmp_path):
    lps = _lps()
    bad = dict(lps["two_phase"])
    bad["b"] = np.where(np.arange(bad["b"].size).reshape(bad["b"].shape)
                        == 3, np.nan, bad["b"])
    sc.save_lps(tmp_path / "bad.npz", {"two_phase": bad})
    out = _run_cards("--device", "cpu", "--ranks", "2", "--phases", "c",
                  "--lps", str(tmp_path / "bad.npz"), "--timeout", "120")
    assert out.returncode == 1
    assert re.search(r"\[failed\] rank [01] exited with code 1 in phase c",
                     out.stdout), out.stdout
    assert "finitos" in out.stdout
    assert _lines(out.stdout, "[summary]")[0]["ok"] is False


def test_a_run_past_its_time_limit_is_killed_and_named(tmp_path):
    out = _run_cards("--device", "cpu", "--ranks", "2", "--phases", "a",
                  "--timeout", "0.5")
    assert out.returncode == 1
    assert re.search(r"time limit of 0\.5 s reached; rank 0 in phase \w+",
                     out.stdout), out.stdout


def test_cuda_without_enough_cards_is_refused():
    out = _run_cards("--ranks", str(torch.cuda.device_count() + 1))
    assert out.returncode == 2
    assert out.stdout.startswith("[refused]")
    assert "[check]" not in out.stdout


def test_the_lps_file_round_trips(tmp_path):
    lps = _lps()
    sc.save_lps(tmp_path / "lps.npz", lps)
    back = sc.load_lps(tmp_path / "lps.npz")
    assert sorted(back) == sorted(lps)
    for name, lp in lps.items():
        for k, v in lp.items():
            if v is None:
                assert back[name][k] is None
            else:
                np.testing.assert_array_equal(np.asarray(v),
                                              np.asarray(back[name][k]))


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (NCCL across them)")


@pytest.mark.gpu
def test_four_cards_run_the_collectives_and_the_loop(four_cards, tmp_path):
    """Phases (a) and (b) on four cards at the CPU cases' sizes."""
    sc.save_lps(tmp_path / "lps.npz", _lps())
    out = _run_cards("--ranks", "4", "--phases", "ab", "--lps",
                  str(tmp_path / "lps.npz"), "--timeout", "600", timeout=900)
    assert out.returncode == 0, out.stdout[-3000:]
    checks = _lines(out.stdout, "[check]")
    assert all(c["ok"] for c in checks)
    assert all(c["profiled"]["nccl_kernels"] >= 4 * c["profiled"]["steps"]
               for c in checks if c["phase"] == "b")
