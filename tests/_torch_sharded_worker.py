"""One gloo rank of the port's multi-rank tests (tests/test_torch_sharded.py,
tests/test_torch_distributed.py).  It imports the port and never JAX.

    python tests/_torch_sharded_worker.py sharded OUT_DIR STORE RANK WORLD
    python tests/_torch_sharded_worker.py distributed OUT_DIR

``sharded`` joins a gloo group through ``parallel.distributed.initialize``
at the ``file://`` store STORE and, for every mesh of ``MESHES`` and case
of ``CASES``, runs ``solve_tableau_sharded`` on this rank's shards (float64),
recording the ``go`` flag each of its steps left (the loop's exit), and
``solve_arrays_sharded`` with certification, gathers the whole batch
and writes everything to ``OUT_DIR/rank{RANK}.npz``.  ``distributed`` takes
its group from the ``SIMPLEX_TPU_*`` variables and solves ``dist_lp()``
with ``solve_arrays_distributed`` on a 1x4 mesh.  Both print ``RANK-OK``.
"""
import os
import sys

import numpy as np

# (batch, row) layouts of the eight ranks, as tests/test_sharded.py uses.
MESHES = [(2, 4), (1, 8), (4, 2)]


def _two_phase(seed=3, B=4, m=12, n=6):
    """Feasible LPs with <=, >= and = rows (tests/test_sharded.py:87's
    recipe, cut to m=12: padded to 16 on a row axis of 8)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)).round(3)
    x0 = rng.uniform(0.1, 2.0, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0)
    ops = rng.choice([-1, 1, 0], size=m, p=[0.7, 0.2, 0.1])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.where(ops == -1, b + slack, np.where(ops == 1, b - slack, b))
    c = (np.abs(rng.normal(size=(B, n))) + 0.01).round(3)
    return dict(c=c, A=A, b=b, ops=ops, maximize=False, ub=None)


def _native_bounds(seed=77, B=8, m=16, n=6):
    """tests/test_sharded.py:206's bounded batch with mixed rows."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)).round(2)
    x0 = rng.uniform(0.2, 2.0, size=(B, n))
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.einsum("bmn,bn->bm", A, x0) + np.where(
        ops == -1, slack, np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=(B, n)).round(2)
    has_ub = rng.random((B, n)) < 0.6
    ub = np.where(has_ub,
                  x0 + rng.uniform(-0.3, 1.5, size=(B, n)).clip(0.01),
                  np.inf)
    return dict(c=c, A=A, b=b, ops=ops, maximize=False, ub=ub)


def _bound_flip_tall(seed=13, B=2, m=256, n=12):
    """tests/test_sharded.py:248's tall LPs whose optimum sits at upper
    bounds, reached through bound flips."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    x0 = rng.uniform(0.5, 1.5, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0) + rng.uniform(0.1, 0.8, (B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ub = np.where(rng.random((B, n)) < 0.7,
                  x0 * rng.uniform(0.7, 1.3, (B, n)), np.inf)
    return dict(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True, ub=ub)


def _uneven_shards(seed=5, B=4, m=12, n=6):
    """tests/test_sharded.py:38's mixed rows (every instance infeasible),
    ordered so that the first instance stops first: on a batch axis of 2
    or 4, batch shard 0 stops before the others."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)).round(2)
    b = rng.uniform(-2, 9, size=(B, m)).round(2)
    c = rng.normal(size=(B, n)).round(2)
    ops = rng.choice([-1, 0, 1], size=m)
    order = [1, 2, 3, 0]
    return dict(c=c[order], A=A[order], b=b[order], ops=ops,
                maximize=False, ub=None)


CASES = {"two_phase": _two_phase, "native_bounds": _native_bounds,
         "bound_flip_tall": _bound_flip_tall, "uneven_shards": _uneven_shards}


def dist_lp():
    """tests/test_distributed.py's LPs: 2 x 32 x 10, all <=, maximize."""
    rng = np.random.default_rng(7)
    B, m, n = 2, 32, 10
    A = rng.uniform(0.2, 2.0, size=(B, m, n))
    x0 = rng.uniform(0.5, 1.5, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0) + rng.uniform(0.5, 1.0, size=(B, m))
    c = rng.uniform(0.5, 2.0, size=(B, n))
    return c, A, b, np.full((m,), -1, np.int8)


def _sharded(out_dir, store, rank, world):
    import torch
    from simplex_tpu_torch.parallel import distributed as pd
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.runtime import graphs

    torch.set_num_threads(1)
    assert pd.initialize(coordinator_address=f"file://{store}",
                         num_processes=world, process_id=rank, device="cpu")
    # The go flag after each step the sharded loop runs.
    gos = []
    steps = graphs.steps

    def recorded(state, n_steps):
        for k in steps(state, n_steps):
            yield k
            gos.append(bool(state["go"]))

    graphs.steps = recorded
    res = {}
    for shape in MESHES:
        mesh = ps.make_mesh(*shape)
        assert mesh.shape == {"batch": shape[0], "row": shape[1]}
        for name, make in CASES.items():
            raw = make()
            _, arrays, bounded = ps.compile_sharded(
                raw["c"], raw["A"], raw["b"], raw["ops"], raw["maximize"],
                *shape, dtype=np.float64, ub=raw["ub"])
            shards = [pd.put_global(a, pd.NamedSharding(mesh, spec, "cpu"))
                      for a, spec in zip(arrays, ps.SPECS)]
            gos.clear()
            T, basis, obj, status, iters, at_up = ps.solve_tableau_sharded(
                *shards, mesh=mesh, bounded=bounded)
            key = f"{shape[0]}x{shape[1]}_{name}"
            res[key + "_go"] = np.array(gos, bool)
            res[key + "_basis"] = ps._gather_batch(
                ps._gather_rows(basis, mesh), mesh).numpy()
            res[key + "_obj"] = ps._gather_batch(obj, mesh).numpy()
            res[key + "_status"] = ps._gather_batch(status, mesh).numpy()
            res[key + "_at_upper"] = ps._gather_batch(at_up, mesh).numpy()
            res[key + "_iters"] = np.int64(iters)
            out = ps.solve_arrays_sharded(
                raw["c"], raw["A"], raw["b"], raw["ops"],
                maximize=raw["maximize"], mesh=mesh, dtype=np.float64,
                ub=raw["ub"], device="cpu")
            for f, v in out.items():
                res[f"{key}_arrays_{f}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def _distributed(out_dir):
    import torch
    from simplex_tpu_torch.parallel import distributed as pd

    torch.set_num_threads(1)
    rank = int(os.environ["SIMPLEX_TPU_PROCESS_ID"])
    assert pd.initialize(device="cpu")
    assert pd.initialize(device="cpu")          # a second call: no-op
    mesh = pd.make_global_mesh(row=4, batch=1)
    assert mesh.shape == {"batch": 1, "row": 4}
    c, A, b, ops = dist_lp()
    out = pd.solve_arrays_distributed(c, A, b, ops, maximize=True,
                                      mesh=mesh, device="cpu")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    return rank


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if sys.argv[1] == "sharded":
        r = int(sys.argv[4])
        _sharded(sys.argv[2], sys.argv[3], r, int(sys.argv[5]))
    else:
        r = _distributed(sys.argv[2])
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"{r}-OK", flush=True)
