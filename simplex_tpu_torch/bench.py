"""The port's measurement entry point: ``python -m simplex_tpu_torch.bench``.

The counterpart of the repo's ``bench.py`` and its ``main()``: the same
modes, flags and defaults, each printing exactly one JSON line with
bench.py's ``metric``, ``value``, ``unit``, ``vs_baseline`` and ``detail``:

    python -m simplex_tpu_torch.bench                  # pivot rate, 10241²,
                                                       # and the four batched
                                                       # sub-benches
    python -m simplex_tpu_torch.bench --batch [--batch-size 16384]
    python -m simplex_tpu_torch.bench --solve-dense    # the 2048² LP
    python -m simplex_tpu_torch.bench --pdhg           # 65,536 x (20x30)
    python -m simplex_tpu_torch.bench --sharded        # 10240, 1x1 mesh
    python -m simplex_tpu_torch.bench --stream         # 1,000,000 by PDHG
    python -m simplex_tpu_torch.bench --stream-exact   # 16 x 65,536 exact

Every mode runs on the card (``--device cuda``, the default, which raises
where there is none); ``--device cpu`` runs the kernels' plain twins, for
tests at small sizes.  ``detail["launches"]`` (added to bench.py's keys)
holds the launches of each kernel of the port during the mode: K1 (pivot
rate, dense solve, the sharded mode's comparison), K2 (the batched cells,
the streams' batched solves), K3 (the bounded sub-benches), K4 (the pivot
rate's ceiling); none on the CPU, where the twins run.

Two things of bench.py's ``main()`` are left out on purpose.  It writes no
file: the line on standard output is the result, and keeping it (a
benchmark's record) is for whoever runs the command.  And an error is not
turned into a fallback measurement: bench.py prints a 2048² pivot bench
in place of a mode that failed, which would report another cell under the
mode's command; here an error exits non-zero with its traceback, and a
batched sub-bench that fails fails the default mode.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from .config import torch_device
from .runtime import graphs

KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
# The kernels, in the order of the wrappers' launch counters
# (graphs._counters).
KERNELS = ("K1", "K2", "K3", "K4")


def parser() -> argparse.ArgumentParser:
    """bench.py's flags with their defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.bench",
        description="Measure one cell of the port; print one JSON line.")
    p.add_argument("--size", type=int, default=10240,
                   help="tableau dimension for the pivot-update benchmark")
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--reps", type=int, default=5,
                   help="timed repetitions per mode; medians are reported")
    p.add_argument("--batch", action="store_true",
                   help="run the batched-solve benchmark instead")
    p.add_argument("--batch-size", type=int, default=None,
                   help="instance count for --batch / --pdhg")
    p.add_argument("--pdhg", action="store_true",
                   help="run the first-order (PDHG) sweep benchmark")
    p.add_argument("--solve-dense", action="store_true",
                   help="run the end-to-end single-LP dense-solve benchmark")
    p.add_argument("--sharded", action="store_true",
                   help="run the row-sharded loop on a 1x1 mesh")
    p.add_argument("--stream", action="store_true",
                   help="run the end-to-end PDHG streaming sweep")
    p.add_argument("--stream-exact", action="store_true",
                   help="run the exact f64-certified simplex sweep")
    p.add_argument("--stream-total", type=int, default=1_000_000)
    p.add_argument("--no-batched-detail", action="store_true",
                   help="skip the batched sub-benchmarks in the default mode")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "GPU) or cpu (the kernels' plain twins)")
    return p


def run(args: argparse.Namespace) -> Dict:
    """The record of the mode ``args`` selects, bench.py's size rules
    included."""
    dev = torch_device(args.device)
    if args.pdhg:
        from .utils.sweep_bench import bench_pdhg

        return bench_pdhg(B=args.batch_size or 65536, reps=args.reps,
                          device=dev)
    if args.batch:
        from .utils.solve_bench import bench_batched_solve

        return bench_batched_solve(B=args.batch_size or 1024,
                                   reps=args.reps, device=dev)
    if args.solve_dense:
        from .utils.solve_bench import bench_dense_solve

        return bench_dense_solve(args.size if args.size != 10240 else 2048,
                                 device=dev)
    if args.sharded:
        from .utils.sharded_bench import bench_sharded

        return bench_sharded(args.size, args.iters, reps=min(args.reps, 3),
                             compare_size=min(8192, args.size), device=dev)
    if args.stream_exact:
        from .utils.sweep_bench import bench_stream_exact

        total = args.stream_total
        if total == 1_000_000:
            total = 1_048_576          # 16 x 65536: one chunk shape
        return bench_stream_exact(total=total, chunk=min(65536, total),
                                  device=dev)
    if args.stream:
        from .utils.sweep_bench import bench_stream

        return bench_stream(total=args.stream_total,
                            chunk=min(250_000, args.stream_total),
                            device=dev)
    from .utils.pivot_bench import bench_pivot_update

    return bench_pivot_update(args.size, args.iters, reps=args.reps,
                              device=dev,
                              with_batched=not args.no_batched_detail)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run one mode and print its JSON line; returns the printed record."""
    args = parser().parse_args(argv)
    for mod, attr in graphs._counters():
        setattr(mod, attr, 0)
    out = run(args)
    rec = {k: out[k] for k in KEYS}
    rec["detail"] = dict(rec["detail"], launches=dict(
        zip(KERNELS, graphs._read_counters())))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
