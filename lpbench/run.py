"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): import the port,
build or load its kernels, make the cell's inputs from ``--seed``, and make
the cell's warm calls, which capture its CUDA graphs.  The window then
calls the cell's entry back to back on the inputs, cycled, for
``--seconds``; every call started in the window is finished.  After it the
peak device memory is read, the program's state is freed, and the plain
reference judges every answer of the window (``reference/``).  The last
line of standard output is the run's JSON result; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of that object.

``--trace 1`` also wraps the program's functions named by the entry in
host spans and runs one ``torch.profiler`` session from before the warm-up
to the end of the window; it reports the cell's per-layer metrics instead
of its end-to-end ones.  ``--device cpu`` runs the port's plain twins on
the CPU, for the tests; a run without it needs as many CUDA cards as the
cell asks for.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# Whole top-level module names the port must not load (the JAX package's
# name is a prefix of the port's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "simplex_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat", encoding="ascii") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time() - time.process_time()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m lpbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"[lpbench] {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, manifest_path=None) -> int:
    t_proc = process_start()
    args = _parse(argv)
    from . import registry

    bench = registry.manifest(manifest_path or registry.MANIFEST)
    cell = registry.cell(args.workload, bench)
    chips = cell["entry"]["chips"]

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA card: this cell runs on the card", 2)
        if torch.cuda.device_count() < chips:
            return _fail(f"{torch.cuda.device_count()} CUDA card(s); the "
                         f"cell asks for {chips}", 2)
    from . import harness

    entry = registry.module("entries", cell["workload"]["entry"])
    return getattr(entry, "run", harness.run)(args, cell, t_proc, entry)


if __name__ == "__main__":
    sys.exit(main())
