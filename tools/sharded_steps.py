#!/usr/bin/env python3
"""The sharded loop's steps, chunks and seconds in one tree of the repo.

    python3 tools/sharded_steps.py ROOT LABEL

Imports ``simplex_tpu_torch`` and ``chip_smoke.py`` from the checkout at
ROOT (this repo, or an older commit unpacked by ``git archive`` into a
directory that ``.gitignore`` lists), builds a one-rank NCCL group as
``chip_smoke.py`` phase 20 does, and runs ``solve_tableau_sharded`` on
phase 20's LPs (config 5's generator cut to 32,768 rows, the 8192 x 192,
16384 x 8 and 2 x 256 x 12 bounded LPs of ``tests/test_sharded.py``, the
mixed and mixed bounded 256 x (30x50) batches): one warm solve, then three
timed ones (host clock around a synchronised solve), each with its
iterations, the chunks it ran and the steps ``runtime/graphs.py`` counted
(0 in trees whose sharded loop runs no ``graphs.steps``: there every chunk
runs its full length).  Then ``utils/sharded_bench.bench_sharded(10240,
64, 3, compare_size=8192)``.  Prints one line ``RESULT {json}`` tagged
with LABEL.  Run two trees in turns in one call to compare them (parent,
change, change, parent).  Needs a CUDA card; imports nothing of JAX.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from simplex_tpu_torch.parallel import distributed as pdist  # noqa: E402
from simplex_tpu_torch.parallel import sharded as psh  # noqa: E402
from simplex_tpu_torch.runtime import graphs  # noqa: E402
from simplex_tpu_torch.utils.sharded_bench import bench_sharded  # noqa: E402


def lps():
    """Phase 20's LPs as (name, (c, A, b, ops, maximize, ub), max_iters)."""
    c, A, b, ops, maxi = cs.mixed_batch(256)
    cu, Au, bu, opsu, ubu = cs.mixed_bounded_batch(256)
    flip = cs.bound_flip_lp()
    return [("config5_32768", cs.config5_lp() + (True, None), 512),
            ("many_pivot_8192x192", cs.many_pivot_lp() + (True, None), 2048),
            ("mechanism_16384x8", cs.mechanism_lp() + (True, None), 64),
            ("bound_flip_2x256x12", flip[:4] + (True, flip[4]), 4096),
            ("mixed_256", (c, A, b, ops, maxi, None), 4096),
            ("mixed_bounded_256", (cu, Au, bu, opsu, False, ubu), 4096)]


def main():
    pdist.initialize(f"file://{tempfile.mkdtemp()}/store", 1, 0)
    probe = torch.ones(1, device="cuda")
    torch.distributed.all_reduce(probe)
    torch.cuda.synchronize()
    out = {"tree": sys.argv[2]}
    for name, (c, A, b, ops, maxi, ub), max_iters in lps():
        _, arrays, bounded = psh.compile_sharded(c, A, b, ops, maxi, ub=ub)
        mesh = psh.make_mesh()
        args = psh.stage_shards(arrays, mesh, "cuda")

        def solve():
            return psh.solve_tableau_sharded(*args, mesh=mesh,
                                             max_iters=max_iters,
                                             bounded=bounded)

        solve()
        runs = []
        for _ in range(3):
            steps = graphs.STEPS
            chunks = graphs.REPLAYS + graphs.EAGER_CHUNKS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            runs.append({"s": time.perf_counter() - t0, "iters": res[4],
                         "chunks": graphs.REPLAYS + graphs.EAGER_CHUNKS
                         - chunks, "steps_counted": graphs.STEPS - steps})
        out[name] = runs
        del args, res
        torch.cuda.empty_cache()
    rec = bench_sharded(10240, 64, 3, compare_size=8192)
    out["bench_sharded"] = rec["detail"]
    out["bench_sharded_value"] = rec["value"]
    out["bench_sharded_vs_baseline"] = rec["vs_baseline"]
    print("RESULT " + json.dumps(out), flush=True)
    graphs.clear()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
