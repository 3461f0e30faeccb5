#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``simplex_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises, so the exit code is non-zero:

1. environment: the card (``nvidia-smi``), torch and CUDA versions; no
   CUDA device is a failure (there is no CPU path here);
2. build: compiles the port's CUDA kernels from ``simplex_tpu_torch/csrc``;
3. K1 (``csrc/pivot_update.cu``) against its plain PyTorch twin on the card
   at (257, 300), (2304, 4608) (the tableau of the 2048 x 2048 dense LP)
   and (10240, 10240), then timed against the twin with CUDA events;
4. the report path: the CLI (``simplex_tpu_torch.cli``) on the three
   anchor problems, checked against their known optima;
5. the main path at full size: ``simplex_tpu_torch.solve_lp`` on the
   2048 x 2048 dense LP of ``bench.py::bench_dense_solve``, checked against
   HiGHS, with the K1 launch count of that run.

The line before the last holds the card's name and power limit as
``nvidia-smi`` prints them; the line before that the kernel record (JSON);
the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg):
    print(msg, flush=True)


def _gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def _time_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_k1(torch, pivot_kernel):
    """K1 against its twin at the main path's shapes; returns the worst
    absolute difference seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def idx(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    def flag(v):
        return torch.full((), v, dtype=torch.bool, device=dev)

    worst = 0.0
    for R, W in [(257, 300), (2304, 4608), (10240, 10240)]:
        T0 = torch.randn((R, W), generator=gen, device=dev)
        T0[:, -1] = T0[:, -1].abs()
        T0[1, -1] = -1e-3            # a negative RHS lane for the clamp
        tmax = float(T0.abs().max())
        shape_err = 0.0
        for clamp in (False, True):
            for r, s in [(0, 0), (1, 1), (R // 2, W // 3), (R - 1, W - 2)]:
                got = T0.clone()
                pivot_kernel.pivot_update_(got, idx(r), idx(s), flag(True),
                                           clamp_rhs=clamp)
                ref = pivot_kernel.pivot_update_ref(T0.clone(), idx(r),
                                                    idx(s), flag(True),
                                                    clamp_rhs=clamp)
                torch.cuda.synchronize()
                shape_err = max(shape_err, float((got - ref).abs().max()))
                torch.testing.assert_close(got, ref, rtol=1e-6,
                                           atol=1e-6 * tmax)
                check(torch.equal(got[r], ref[r]),
                      f"K1 row {r} differs at {R}x{W}")
                check(torch.equal(got[:, s], ref[:, s]),
                      f"K1 column {s} differs at {R}x{W}")
        same = T0.clone()
        pivot_kernel.pivot_update_(same, idx(3), idx(4), flag(False),
                                   clamp_rhs=True)
        torch.cuda.synchronize()
        check(torch.equal(same, T0), f"do_pivot=0 changed T at {R}x{W}")
        log(f"[k1] {R}x{W}: matches twin (clamp on/off, 4 pivots, "
            f"do_pivot=0 no-op), max_abs_err={shape_err!r}")
        worst = max(worst, shape_err)
        del T0, got, ref, same
    return worst


def phase_k1_timing(torch, pivot_kernel, gpu):
    """ms per pivot of K1 and of its twin, and torch's own copy as the
    card's streaming yardstick; returns (kernel_ms, twin_ms) at 10240^2."""
    dev = torch.device("cuda")
    out = {}
    for R, W in [(2304, 4608), (10240, 10240)]:
        T = torch.randn((R, W), device=dev)
        dst = torch.empty_like(T)
        r = torch.full((), R // 2, dtype=torch.int64, device=dev)
        s = torch.full((), W // 3, dtype=torch.int64, device=dev)
        go = torch.full((), True, dtype=torch.bool, device=dev)
        nbytes = 2 * R * W * 4
        k_ms = _time_ms(lambda: pivot_kernel.pivot_update_(
            T, r, s, go, clamp_rhs=True))
        p_ms = _time_ms(lambda: pivot_kernel.pivot_update_ref(
            T, r, s, go, clamp_rhs=True))
        c_ms = _time_ms(lambda: dst.copy_(T))
        log(f"[k1-time] {R}x{W} f32 on {gpu}: K1 {k_ms!r} ms/pivot "
            f"({nbytes / k_ms / 1e6!r} GB/s at 2*R*W*4 B), twin "
            f"{p_ms!r} ms/pivot, torch copy_ {c_ms!r} ms "
            f"({nbytes / c_ms / 1e6!r} GB/s)")
        out[(R, W)] = (k_ms, p_ms)
        del T, dst
    return out[(10240, 10240)]


def phase_cli(cli, storage_mod, tmpdir):
    anchors = [
        ({"type": "maximize", "coefficients": {"x1": 15.0, "x2": 18.0}},
         [([4.0, 2.0], "<=", 2000.0), ([2.0, 6.0], "<=", 2400.0),
          ([20.0, 28.0], "<=", 14000.0)], 9833.3333),
        ({"type": "minimize", "coefficients": {"x1": 50.0, "x2": 80.0}},
         [([4.0, 1.0], ">=", 4.0), ([1.0, 6.0], ">=", 6.0),
          ([4.0, 6.0], ">=", 12.0)], 153.3333),
        ({"type": "minimize", "coefficients": {"x1": 2.0, "x2": 3.0}},
         [([1.0, 1.0], ">=", 5.0), ([2.0, 1.0], ">=", 8.0)], 10.0),
    ]
    for k, (obj, rows, z_expected) in enumerate(anchors):
        wrapper = {"problema_definicion": {
            "funcion_objetivo": obj,
            "restricciones": [
                {"coefficients": {"x1": a[0], "x2": a[1]}, "operator": op,
                 "rhs": rhs} for a, op, rhs in rows]}}
        path = os.path.join(tmpdir, f"anchor{k}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(wrapper, f)
        rc = cli.main(["solve", path])
        check(rc == 0, f"cli solve {path} returned {rc}")
        report = storage_mod.StorageService().load_solution()
        sol = report["solucion_encontrada"]
        check(sol["status"] == "Solucion Factible",
              f"anchor {k}: status {sol['status']!r}")
        check(round(sol["valor_optimo_z"], 4) == z_expected,
              f"anchor {k}: Z={sol['valor_optimo_z']!r}, "
              f"expected {z_expected}")
        check(len(report["tablas_intermedias"]) > 0,
              f"anchor {k}: no tablas_intermedias")
        log(f"[cli] anchor {k}: Z={sol['valor_optimo_z']!r} "
            f"({len(report['tablas_intermedias'])} tables)")


def dense_lp(size):
    """The LP of bench.py::bench_dense_solve (same generator and seed)."""
    rng = np.random.default_rng(0)
    m = n = size
    A = rng.uniform(0.05, 1.0, size=(m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    return c, A, b


def phase_solve(torch, pt, pivot_kernel, gpu, size=2048):
    from scipy.optimize import linprog

    c, A, b = dense_lp(size)
    lp = pt.LinearProgram(c=c, A=A, b=b, ops=np.full(size, -1),
                          maximize=True)
    cfg = pt.SolverConfig(device="cuda")
    warm = pt.solve_lp(lp, cfg)
    check(warm.status == 0, f"warm-up solve status {warm.status}")

    pivot_kernel.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve_lp(lp, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pivot_kernel.LAUNCHES

    check(res.status == 0, f"{size} solve status {res.status}")
    check(res.x is not None and res.x.shape == (size,)
          and bool(np.all(np.isfinite(res.x))), f"{size} solve x not finite")
    t1 = time.perf_counter()
    ref = linprog(-c, A_ub=A, b_ub=b, method="highs")
    highs_s = time.perf_counter() - t1
    check(ref.status == 0, f"HiGHS status {ref.status}")
    z_ref = -ref.fun
    check(abs(res.z - z_ref) <= 1e-6 * (1.0 + abs(z_ref)),
          f"z={res.z!r} vs HiGHS {z_ref!r}")
    check(launches >= 1, "the solve launched K1 no time")
    if not res.escalated:
        check(launches >= res.nit,
              f"K1 launches {launches} < pivots {res.nit}")
    log(f"[solve] {size}x{size} dense LP on {gpu}: status 0, z={res.z!r} "
        f"(HiGHS {z_ref!r}, {highs_s!r} s on the host), pivots={res.nit}, "
        f"wall={wall!r} s, {res.nit / wall!r} pivots/s, "
        f"escalated={res.escalated}, K1 launches={launches}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on "
                           "a GPU and has no CPU path")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    os.environ["SIMPLEX_TPU_OUTPUT_DIR"] = tmp.name
    import simplex_tpu_torch as pt
    from simplex_tpu_torch import cli
    from simplex_tpu_torch.ops import pivot_kernel
    from simplex_tpu_torch.runtime import kernels
    from simplex_tpu_torch.services import storage as storage_mod

    # 1. environment
    gpu = _gpu_line()
    log(f"[env] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s), python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    log(f"[build] {os.path.relpath(lib_path)} in "
        f"{time.perf_counter() - t0!r} s")
    with open(lib_path + ".log", encoding="utf-8") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    # 3. K1 against its twin, then timed
    max_err = phase_k1(torch, pivot_kernel)
    k_ms, p_ms = phase_k1_timing(torch, pivot_kernel, gpu)

    # 4. report path through the CLI
    pivot_kernel.LAUNCHES = 0
    phase_cli(cli, storage_mod, tmp.name)
    log(f"[cli] K1 launches over the three reports: {pivot_kernel.LAUNCHES}")
    check(pivot_kernel.LAUNCHES >= 1, "the report path launched K1 no time")

    # 5. the main path at full size
    launches = phase_solve(torch, pt, pivot_kernel, gpu)
    tmp.cleanup()

    log(json.dumps({"kernels": [{
        "name": "K1 pivot_update",
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/pivot_update.cu",
        "replaces": "simplex_tpu/ops/pallas_pivot.py:67",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
