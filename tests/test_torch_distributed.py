"""The port's multi-process runtime (``simplex_tpu_torch.parallel.distributed``).

Four gloo processes (``_torch_sharded_worker``, the port only) join through
the ``SIMPLEX_TPU_*`` variables and solve ``tests/test_distributed.py``'s
LPs on a 1x4 row mesh; every rank must return the same dict, equal to
scipy's and to the JAX ``solve_arrays_distributed`` within
1e-6 (1 + |z|).  The ``gpu`` case runs on the card alone (it imports no
JAX):

    python -m pytest tests/test_torch_distributed.py -m gpu --noconftest
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_sharded_worker as worker
from simplex_tpu_torch.parallel import distributed as pd
from simplex_tpu_torch.parallel import sharded as ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ("SIMPLEX_TPU_COORDINATOR", "SIMPLEX_TPU_NUM_PROCESSES",
        "SIMPLEX_TPU_PROCESS_ID")


def test_initialize_without_env_is_a_no_op(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert pd.initialize() is False
    assert pd.initialize(num_processes=1, device="cpu") is False
    monkeypatch.setenv("SIMPLEX_TPU_NUM_PROCESSES", "1")
    assert pd.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("preset", [None, "1"])
def test_an_nccl_group_turns_off_graph_mixing_unless_set(monkeypatch,
                                                         preset):
    """NCCL's graph-mixing support puts event nodes into every captured
    call, which a WHILE body does not take; the user's own setting wins."""
    calls = []
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    if preset is None:
        monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", preset)
    monkeypatch.setattr(pd, "torch_device", lambda name: torch.device(name))
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert pd.initialize("file:///nowhere", 4, 3, device="cuda")
    assert calls == [3, ("nccl", dict(init_method="file:///nowhere",
                                      world_size=4, rank=3))]
    assert os.environ["NCCL_GRAPH_MIXING_SUPPORT"] == (preset or "0")


def test_gloo_leaves_the_nccl_setting_alone(monkeypatch):
    monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: None)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert pd.initialize("file:///nowhere", 2, 0, device="cpu")
    assert "NCCL_GRAPH_MIXING_SUPPORT" not in os.environ


def test_put_global_gives_each_rank_its_shard():
    x = np.arange(4 * 8 * 3, dtype=np.float64).reshape(4, 8, 3)
    for k in range(8):
        mesh = ps.Mesh(2, 4, k)
        t = pd.put_global(x, pd.NamedSharding(mesh, ("batch", "row", None),
                                              "cpu"))
        b, r = divmod(k, 4)
        np.testing.assert_array_equal(t.numpy(),
                                      x[2 * b:2 * b + 2, 2 * r:2 * r + 2])
        rep = pd.put_global(x[:, 0], pd.NamedSharding(mesh, ("batch", None),
                                                      "cpu"))
        np.testing.assert_array_equal(rep.numpy(), x[2 * b:2 * b + 2, 0])


def _scipy(c, A, b):
    from scipy.optimize import linprog

    return [linprog(-c[i], A_ub=A[i], b_ub=b[i], method="highs")
            for i in range(len(c))]


def test_four_gloo_processes_return_one_dict(tmp_path):
    script = os.path.join(REPO, "tests", "_torch_sharded_worker.py")
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                GLOO_SOCKET_IFNAME="lo",
                SIMPLEX_TPU_COORDINATOR=f"file://{tmp_path / 'store'}",
                SIMPLEX_TPU_NUM_PROCESSES="4")
    base.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, script, "distributed", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(base, SIMPLEX_TPU_PROCESS_ID=str(r))) for r in range(4)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"{r}-OK" in log, log[-4000:]
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for other in outs[1:]:
        assert set(other) == set(outs[0])
        for k, v in outs[0].items():
            np.testing.assert_array_equal(v, other[k], err_msg=k)
    out = outs[0]
    assert int(out["processes"]) == 4 and tuple(out["mesh"]) == (1, 4)

    c, A, b, ops = worker.dist_lp()
    for i, ref in enumerate(_scipy(c, A, b)):
        assert ref.status == 0 and out["status"][i] == 0
        assert abs(out["z"][i] + ref.fun) <= 1e-6 * (1 + abs(ref.fun))

    # The JAX reference, imported here so that the gpu case runs without
    # JAX (conftest pins JAX to the CPU).
    from simplex_tpu.parallel import distributed as jd

    jref = jd.solve_arrays_distributed(
        c, A, b, ops, maximize=True, mesh=jd.make_global_mesh(row=4, batch=1))
    np.testing.assert_array_equal(jref["status"], out["status"])
    assert np.all(np.abs(out["z"] - jref["z"])
                  <= 1e-6 * (1 + np.abs(jref["z"])))
    np.testing.assert_allclose(out["x"], jref["x"], rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL runs there)")


@pytest.mark.gpu
def test_one_rank_nccl_solve_equals_the_identity_mesh(cuda, tmp_path):
    """One NCCL rank on the card against no process group (bit for bit),
    and in float64 against the CPU."""
    case = worker.CASES["native_bounds"]()
    args = (case["c"], case["A"], case["b"], case["ops"])
    kw = dict(maximize=False, ub=case["ub"], certify=False)
    plain = ps.solve_arrays_sharded(*args, **kw)
    cpu64 = ps.solve_arrays_sharded(*args, dtype=np.float64, device="cpu",
                                    **kw)
    assert not pd.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        nccl = ps.solve_arrays_sharded(*args, **kw)
        gpu64 = ps.solve_arrays_sharded(*args, dtype=np.float64, **kw)
    finally:
        torch.distributed.destroy_process_group()
    assert plain["iters"] == nccl["iters"]
    for k in ("status", "x", "z"):
        np.testing.assert_array_equal(plain[k], nccl[k], err_msg=k)
    assert cpu64["iters"] == gpu64["iters"]
    np.testing.assert_array_equal(cpu64["status"], gpu64["status"])
    ok = cpu64["status"] == 0
    assert np.all(np.abs(gpu64["z"][ok] - cpu64["z"][ok])
                  <= 1e-9 * (1 + np.abs(cpu64["z"][ok])))
