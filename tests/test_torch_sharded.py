"""The port's row-sharded solve (``simplex_tpu_torch.parallel.sharded``)
against the JAX reference (``simplex_tpu.parallel.sharded``).

Single rank: no process group, the 1x1 mesh on the CPU, against the JAX
function on a (1, 1) mesh in this process; in float64 the two are
step-equal (status, iterations, basis, at_upper; z within 1e-9 (1 + |z|)),
in float32 the solve-level gate holds (status, z within 1e-6 (1 + |z|),
certification).  Multi-rank: eight gloo ranks (``_torch_sharded_worker``,
one process each, the port only) run the meshes (2, 4), (1, 8) and (4, 2),
each held step-equal to the JAX function on the same mesh of the eight
virtual devices that conftest gives this process.
"""
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_worker as worker
from _torch_parity import CPU

from simplex_tpu.parallel import distributed as jd
from simplex_tpu.parallel import sharded as js
from simplex_tpu_torch.parallel import distributed as pd
from simplex_tpu_torch.parallel import sharded as ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _classic(seed=7, B=6, m=8, n=5):
    """tests/test_sharded.py:57's all-<= LPs (phase 2 from the start)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 2.0, size=(B, m, n))
    b = rng.uniform(1.0, 8.0, size=(B, m))
    c = rng.uniform(0.1, 2.0, size=(B, n))
    return dict(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True, ub=None)


SINGLE = dict(classic=_classic, **worker.CASES)


def _compiled(case, shape=(1, 1), dtype=np.float64):
    """The global inputs of ``solve_tableau_sharded`` for ``case`` on a
    mesh of ``shape`` (padded as ``solve_arrays_sharded`` pads), and
    whether the batch is bounded."""
    _, arrays, bounded = ps.compile_sharded(
        case["c"], case["A"], case["b"], case["ops"], case["maximize"],
        *shape, dtype=dtype, ub=case["ub"])
    return arrays, bounded


def _jax_tableau(case, shape, dtype=np.float64, **kw):
    """The JAX ``solve_tableau_sharded`` on ``shape``'s mesh, as numpy:
    (T_rows, basis, obj, status, iters, at_upper)."""
    arrays, bounded = _compiled(case, shape, dtype)
    with jax.enable_x64(dtype == np.float64):
        out = js.solve_tableau_sharded(
            *[jnp.asarray(a) for a in arrays], mesh=js.make_mesh(*shape),
            bounded=bounded, **kw)
        return [np.asarray(x) for x in out]


def _step_equal(ref, basis, obj, status, iters, at_upper):
    np.testing.assert_array_equal(ref[3], status)
    assert int(ref[4]) == int(iters)
    np.testing.assert_array_equal(ref[1], basis)
    np.testing.assert_array_equal(ref[5], at_upper)
    z_ref, z = ref[2][:, -1], obj[:, -1]
    assert np.all(np.abs(z - z_ref) <= 1e-9 * (1.0 + np.abs(z_ref)))


@pytest.mark.parametrize("devex", [True, False])
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_rank_is_step_equal_in_float64(name, devex):
    """No process group, the 1x1 mesh; a resync every 4 steps."""
    case = SINGLE[name]()
    kw = dict(devex=devex, refactor_every=4)
    ref = _jax_tableau(case, (1, 1), **kw)
    arrays, bounded = _compiled(case)
    mesh = ps.make_mesh(1, 1)
    out = ps.solve_tableau_sharded(*ps.stage_shards(arrays, mesh, CPU),
                                   mesh=mesh, bounded=bounded, **kw)
    T, basis, obj, status, iters, at_upper = out
    assert isinstance(iters, int) and iters > 0
    _step_equal(ref, basis.numpy(), obj.numpy(), status.numpy(), iters,
                at_upper.numpy())
    np.testing.assert_allclose(T.numpy()[..., -1], ref[0][..., -1],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["classic", "native_bounds"])
def test_column_index_in_its_own_sum_gives_the_same_solve(monkeypatch,
                                                          name):
    """Where a column index would not be exact in the tableau's dtype it
    goes through an int64 SUM of its own: the solve is the same."""
    case = SINGLE[name]()
    arrays, bounded = _compiled(case, dtype=np.float32)
    mesh = ps.make_mesh()

    def solve():
        return ps.solve_tableau_sharded(*ps.stage_shards(arrays, mesh, CPU),
                                        mesh=mesh, bounded=bounded)

    packed = solve()
    monkeypatch.setitem(ps._EXACT_INT, torch.float32, 0)
    apart = solve()
    assert packed[4] == apart[4]
    for a, b in zip(packed[:4] + packed[5:], apart[:4] + apart[5:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_rank_solve_level_in_float32(name):
    case = SINGLE[name]()
    args = (case["c"], case["A"], case["b"], case["ops"])
    ref = js.solve_arrays_sharded(*args, maximize=case["maximize"],
                                  mesh=js.make_mesh(1, 1), ub=case["ub"])
    got = ps.solve_arrays_sharded(*args, maximize=case["maximize"],
                                  ub=case["ub"], device=CPU)
    np.testing.assert_array_equal(ref["status"], got["status"])
    np.testing.assert_array_equal(ref["certified"], got["certified"])
    np.testing.assert_array_equal(ref["escalated"], got["escalated"])
    ok = ref["status"] == 0
    assert np.all(np.abs(got["z"][ok] - ref["z"][ok])
                  <= 1e-6 * (1.0 + np.abs(ref["z"][ok])))
    assert np.all(np.isnan(got["z"][~ok]))
    assert got["x"].shape == ref["x"].shape and isinstance(got["iters"], int)


def test_certify_false_leaves_no_certified_key():
    case = worker.CASES["uneven_shards"]()
    raw = ps.solve_arrays_sharded(case["c"], case["A"], case["b"],
                                  case["ops"], maximize=False,
                                  certify=False, device=CPU)
    assert set(raw) == {"x", "z", "status", "iters"}


def test_float64_arrays_match_the_reference_on_one_rank():
    """``solve_arrays_sharded`` in float64: same dict as the JAX one."""
    case = worker.CASES["bound_flip_tall"]()
    args = (case["c"], case["A"], case["b"], case["ops"])
    with jax.enable_x64(True):
        ref = js.solve_arrays_sharded(*args, maximize=True,
                                      mesh=js.make_mesh(1, 1),
                                      dtype=np.float64, ub=case["ub"])
    got = ps.solve_arrays_sharded(*args, maximize=True, dtype=np.float64,
                                  ub=case["ub"], device=CPU)
    assert set(ref) == set(got) and ref["iters"] == got["iters"]
    for k in ("status", "certified", "escalated"):
        np.testing.assert_array_equal(ref[k], got[k])
    np.testing.assert_allclose(got["z"], ref["z"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-9, atol=1e-9)


def test_mesh_without_a_process_group():
    mesh = ps.make_mesh()
    assert mesh.shape == {"batch": 1, "row": 1}
    assert mesh.row_group is None and mesh.batch_group is None
    with pytest.raises(ValueError):
        ps.make_mesh(batch=1, row=2)
    assert pd.make_global_mesh().shape == {"batch": 1, "row": 1}


def test_entry_points_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    case = _classic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.solve_arrays_sharded(case["c"], case["A"], case["b"],
                                case["ops"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.solve_arrays_distributed(case["c"], case["A"], case["b"],
                                    case["ops"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.initialize("localhost:1", 1, 0)


@pytest.mark.parametrize("ref_mod, port_mod", [(js, ps), (jd, pd)],
                         ids=["sharded", "distributed"])
def test_public_names_keep_their_signatures(ref_mod, port_mod):
    """Every public function of the JAX module has a counterpart with the
    same parameters, in order; the port adds ``device`` (where it stages
    arrays) and ``mesh`` (where the JAX arrays carried it)."""
    names = [k for k, v in vars(ref_mod).items()
             if inspect.isfunction(v) and not k.startswith("_")
             and v.__module__ == ref_mod.__name__]
    assert names
    for k in names:
        ref = list(inspect.signature(getattr(ref_mod, k)).parameters)
        got = [p for p in inspect.signature(getattr(port_mod, k)).parameters
               if p not in ref]
        assert got in ([], ["device"], ["mesh"]), (k, got)
        assert [p for p in inspect.signature(getattr(port_mod, k)).parameters
                if p in ref] == ref, k


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Every rank's results (one ``np.load`` a rank) and the JAX references
    for each (mesh, case), computed while the ranks run."""
    out = tmp_path_factory.mktemp("sharded8")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    script = os.path.join(REPO, "tests", "_torch_sharded_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "sharded", str(out), str(out / "store"),
         str(r), "8"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(8)]
    try:
        refs = {}
        for shape in worker.MESHES:
            for name, make in worker.CASES.items():
                refs[shape, name] = _jax_tableau(make(), shape)
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"{r}-OK" in log, log[-4000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return ranks, refs


@pytest.mark.parametrize("name", sorted(worker.CASES))
@pytest.mark.parametrize("shape", worker.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_eight_gloo_ranks_are_step_equal_to_the_reference(eight_ranks, shape,
                                                          name):
    """Every rank's results are the same and step-equal to the JAX
    function.  The loop's ``go`` flag, which ends a chunk at the verdict
    without a collective of its own, is the same on every rank of a row
    group at every step: the ranks of one batch shard run the same steps
    (so the same collectives), one for each iteration of that shard."""
    ranks, refs = eight_ranks
    key = f"{shape[0]}x{shape[1]}_{name}"
    n_row = shape[1]
    gos = [r[key + "_go"] for r in ranks]
    for r, go in enumerate(gos):
        np.testing.assert_array_equal(go, gos[r - r % n_row],
                                      err_msg=f"rank {r}")
        assert len(go) and not go[-1]
    # iters is batch shard 0's count: one step of its loop each.
    assert len(gos[0]) == int(ranks[0][key + "_iters"])
    mine = {k: v for k, v in ranks[0].items()
            if k.startswith(key + "_") and k != key + "_go"}
    assert mine
    for other in ranks[1:]:
        for k, v in mine.items():
            np.testing.assert_array_equal(v, other[k], err_msg=k)
    ref = refs[shape, name]
    _step_equal(ref, mine[key + "_basis"], mine[key + "_obj"],
                mine[key + "_status"], mine[key + "_iters"],
                mine[key + "_at_upper"])
    # The certified dict of solve_arrays_sharded on the same mesh.
    case = worker.CASES[name]()
    B = case["b"].shape[0]
    status = mine[key + "_arrays_status"]
    np.testing.assert_array_equal(status, ref[3][:B])
    assert np.all(mine[key + "_arrays_certified"] | (status == 2))
    ok = status == 0
    z_ref = -ref[2][:B, -1]
    z_ref = np.where(case["maximize"], -z_ref, z_ref)
    z = mine[key + "_arrays_z"]
    assert np.all(np.abs(z[ok] - z_ref[ok]) <= 1e-9 * (1 + np.abs(z_ref[ok])))


def test_bench_sharded_runs_on_the_cpu():
    """``bench_sharded``'s record and keys at a small size (CPU clock)."""
    from simplex_tpu_torch.utils.sharded_bench import bench_sharded

    rec = bench_sharded(size=48, iters=6, reps=2, compare_size=32,
                        device=CPU)
    d = rec["detail"]
    assert rec["metric"] == "sharded_pivots_per_sec_48x48_f32"
    assert d["steady"]["iters"] == 6 and d["with_resync_every_64"]["iters"]
    # m x (n + m) padded to 128 columns, plus the RHS column.
    assert d["steady"]["tableau_MB"] == 48 * 129 * 4 / 1e6
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert d["compare_at"] == 32 and d["device"] == "cpu"


def test_iters_is_batch_shard_zero_count(eight_ranks):
    """The reference returns its unsharded ``iters`` from device 0, so
    batch shard 0's count; the port returns the same on every rank.  Here
    shard 0 stops first, so a batch axis of 2 or 4 reports fewer
    iterations than the (1, 8) mesh, where one shard holds the batch."""
    ranks, refs = eight_ranks
    its = {shape: int(ranks[0][f"{shape[0]}x{shape[1]}_uneven_shards_iters"])
           for shape in worker.MESHES}
    for shape, it in its.items():
        assert it == int(refs[shape, "uneven_shards"][4])
    assert its[2, 4] < its[1, 8] and its[4, 2] < its[1, 8]
