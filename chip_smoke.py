#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``simplex_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises, so the exit code is non-zero:

1. environment: the card (``nvidia-smi``), torch and CUDA versions and
   the driver's; no CUDA device is a failure (there is no CPU path here);
   one empty ``torch.profiler`` session, so that the profiler reports
   every pass of the WHILE nodes of the graphs made later;
2. build: compiles the port's CUDA kernels from ``simplex_tpu_torch/csrc``;
3. K1 (``csrc/pivot_update.cu``, on the streaming skeleton
   ``csrc/stream_common.cuh`` it shares with K4) against its plain PyTorch
   twin on the card, f32 and f64, at (257, 300), (257, 301), (2304, 4608)
   (the tableau of the 2048 x 2048 dense LP), (10240, 10240) and
   (10241, 10241) (the pivot-rate tableau, whose rows start off the 16-byte
   boundary), and on views whose base lies one element past a 16-byte
   boundary; then timed at 2304 x 4608, 10240^2 and 10241^2, one launch
   and chained (64 launches between two CUDA events), against its twin,
   torch's ``copy_`` and ``addr_`` (chained too, in turns with K1);
4. the report path: the CLI (``simplex_tpu_torch.cli``) on the three
   anchor problems, checked against their known optima, each leaving one
   solve record in ``utils/profiling.DEFAULT_METRICS``;
5. the main path at full size: ``simplex_tpu_torch.solve_lp`` on the
   2048 x 2048 dense LP of ``bench.py::bench_dense_solve``, checked against
   HiGHS, with the K1 launch count of that run;
6. K2 (``csrc/fused_pivot_step.cu``, on the batched-step skeleton
   ``csrc/batched_step_common.cuh`` it shares with K3) against its plain
   PyTorch twin on the card: eight successive steps on tableaus that
   ``compile_batch_uniform`` builds (``STEP_CASES``), at 16x128 (mixed
   operators, phase 1 and phase 2 instances, f32 and f64), 32x128 (the
   30x50 batch, B=1024 and B=16384), 64x256 (60x100, mixed), above the
   kernels' 64 KB staging budget (100x150 f32 and 200x300 f64, mixed) and
   unpadded tiles that are not a whole number of 16-byte vectors (9x29 f32
   and f64, 9x23 f32), Dantzig and Devex, Bland on half the instances and
   some instances not running; s, r, flags and basis equal, T and w 0 ulps
   from the twin;
7. K2 timed against its twin and torch's ``copy_`` of the same tableau at
   B=1024 and B=16384 (32x128 f32), CUDA events: one launch from the first
   tableau, and chained (16 successive steps from the first tableau
   between two events, median of 5 with the spread and the host's enqueue
   a call, in turns with chains of ``copy_`` and of K4 in place), the
   chained bound the mean of those 16 steps' own bytes;
8. the batched path at full width: ``BatchedSimplexSolver.solve_arrays``
   on the 16384 x (30x50) batch of ``bench.py::bench_batched_solve``,
   certified, checked against HiGHS on a sample, with the K2 launch count
   of that run and its one launch of the certifier kernel
   (``csrc/certify_bounded.cu``, without bounds: one ``+inf`` row); the
   kernel on that solve's bases, with planted failures, against its twin
   on the card, timed after an L2 flush and chained, the twin too; one more
   run under ``torch.profiler`` (K2's share of the device time); then a 1024 x (30x50) batch with ``>=`` and ``=`` rows
   through the two-phase loop, every verdict checked against HiGHS;
9. K3 (``csrc/fused_pivot_step_bounded.cu``) against its plain PyTorch
   twin on the card: eight successive steps, after three twin steps that
   put columns at their upper bounds, on bounded tableaus of phase 6's
   cases plus 32x128 B=1024 mixed (artificial-exit rows on, the general
   driver's shape; every mixed case runs them), Dantzig and Devex, Bland
   on half the instances, some instances not running; s, r, flags, basis
   and bound state equal, T, w and ub_B 0 ulps from the twin; at least one
   bound flip and one entry from an upper bound must happen;
10. K3 timed as K2 in phase 7 (one launch and chained, in turns with
    ``copy_`` and K4);
11. the bounded path at full width: ``solve_arrays(..., ub=)`` on the
    16384 x (30x50) batch of ``bench.py::bench_bounded_batched`` (60 % of
    the variables bounded), certified, against HiGHS on a sample, with the
    K3 launch count of that run, its stages on the host clock and one run
    under ``torch.profiler``; then a 1024 x (30x50) bounded batch with
    mixed rows through the two-phase loop and a ``solve_lp_sweep`` of 256
    LPs with general bounds, every verdict against HiGHS; (b) the path of
    the benchmark's ``mknapcb9.relax`` cell: ``solve_arrays`` on a 16384 x
    (30x500) draw of its traffic (``lpbench/traffic/mknap.py``, ``ub`` = 1,
    float32, certified), K3 launched exactly once an iteration plus the
    float64 finish's launches and the certifier kernel
    (``csrc/certify_bounded.cu``) once, every answer optimal, certified and
    in its bounds, ``at_upper`` at the bound, the flips counted, 512
    answers against the plain bounded reference
    (``lpbench/reference/bounded.py``); the certifier on that solve's
    claims with ``ub`` and ``at_upper``, failures planted, against its twin
    (flags equal, ``x`` and ``fun`` within 1e-12), timed chained and after
    an L2 flush beside its bound and the twin (in the kernels line); then
    K3 against its twin, 0 ulps, on that draw's float32 tableau (16384 x 32
    x 640) and on a float64 one at the finish's chunk (4096 x 32 x 640),
    whose tiles lie above the 64 KB stage, so every instance streams:
    eight steps from a state 200 K3 steps in, flips and pivots among them;
    one launch of each timed against its twin and its bound (both shapes in
    the kernels line);
12. K4 (``csrc/stream_copy.cu``) against its plain PyTorch twin on the
    card, bit for bit: in place and out of place, f32 and f64, at 10241^2,
    10304 x 10368, 16384 x 32 x 128 and 257 x 300, and on a view one
    element into each;
13. K4, its twin and torch's ``add_`` / ``add(out=)`` timed in both modes
    at 10241^2 and 16384 x 32 x 128; then the pivot-rate path,
    ``utils/pivot_bench.bench_pivot_update(10240, 64, 5)`` (K1 chained 64
    times on the 10241^2 tableau against four streaming ceilings, two of
    them K4's), with its K1 and K4 launch counts and its whole ``detail``
    on one line; then every kernel's time against its bound at 3.35 TB/s
    and against the same bytes at K4's measured in-place ceiling;
14. MPS files and the revised engine on the card: the MPS text of
    ``utils/mps.generate_netlib_adversarial`` for seeds 0-3 (netlib scale,
    BOUNDS / RANGES / FR / MI) through ``cli.main(["solve", f, "--engine",
    e, "--device", "cuda"])`` for every engine (auto, revised, dense,
    host), each status equal to HiGHS's and each optimum within
    1e-6 (1 + |z|), with the K1 launches of the dense runs; then
    ``RevisedSimplexSolver`` on ``generate_netlib_style(1, REVISED_M,
    REVISED_N, density=0.03)``, optimal, not escalated, within the gate of
    HiGHS, at most one host read of the loop state a chunk, with its
    pivots/s and, under ``torch.profiler``, the device busy share and the
    share of the device time in ``linalg.solve_ex`` (the refactor);
15. the web app (``web/app.py::init_app`` through its ``TestClient``) on
    the card: ``GET /``, the max anchor through ``/new`` and ``/solve``
    (Z = 9833.3333, K1 launched), ``/metrics`` with that solve's record,
    ``/exportar-pdf``, an MPS upload to ``/load``, then the CLI's
    ``export-pdf``;
16. the dual reoptimizer (``reoptimize``, every pivot through K1): (a)
    phase 5's LP with ``b`` shrunk by U(0.01, 0.05) (seed 16) from phase
    5's basis, in float64 (in float32 the dual loop diverges on this LP, in
    the JAX package too), against HiGHS, ``solve_tableau_dual`` run once
    and no cold ``solve_lp``, its pivots against a cold solve, its K1
    launches and host reads, and its wall split into the host f64 refactor
    before the loop, the device loop and the f64 certificate after it; (b)
    the bounded dual loop at 384 x 256 (``tests/test_bounds.py:316``'s
    generator, 60 % of the variables bounded) from a revised parent's
    ``(basis, at_upper)``, after an RHS shrink and an RHS increase, against
    HiGHS, no cold fallback;
17. PDHG at ``bench.py::bench_pdhg``'s cell: ``_pdhg_solve`` on staged
    65536 x (20x30) f32 inputs, 10,000 iterations at most, tol 1e-4: the
    median of 3 device solves on CUDA events as LPs/s, the iterations, the
    converged share, the host reads (at most iterations/40 + 2); 256
    sampled instances against HiGHS (2e-3, ``tests/test_engines.py:169``)
    and their residuals recomputed in f64; ``torch.profiler`` over the
    first 401 iterations (device busy share, the matvecs' share); then
    ``PdhgSolver.solve_arrays(ub=)`` on 4096 bounded instances, 512
    sampled against HiGHS;
18. the PDHG stream (``models/pdhg.solve_arrays_stream``) with
    ``crossover="unconverged"`` on 2 chunks of 250,000 x (20x30), half of
    ``bench_stream``'s 1M cell at its full chunk width: every instance
    converged or recovered (the batched recovery launches K2), recovered
    vertices against HiGHS, the wall against the device solve re-timed on
    a staged chunk; then ``crossover="all"`` on 32 instances (one
    ``reoptimize`` an instance, K1);
19. the batched stream (``models/batched.solve_arrays_stream``) on 4
    chunks of 65536 x (30x50) (``bench_stream_exact``'s chunk, seeds
    300+k), certified: chunk 0 equal bit for bit to ``solve_arrays``
    certified on the host as the stream certifies (``solve_arrays``
    certifies it on the card: x and z within 1e-12 of that), the
    certificate of chunk k overlapping the solve of chunk k+1 on the host
    clock, and, under ``torch.profiler`` over two chunks, an upload on the
    side stream overlapping a K2 launch; then a mixed stream of 4 x 16384
    (phase 8's and phase 11's batches in turns), each equal to
    ``solve_arrays`` certified on the host, K2 and K3 both launched;
20. the row-sharded path (``parallel/sharded.py``), through a one-rank
    NCCL group that ``parallel.distributed.initialize`` builds: (a) a
    mixed and a bounded 256 x (30x50) batch bit-equal (status, basis,
    at_upper, iterations, z) to the 1x1 mesh without a group, and over one
    chunk of the mixed batch under ``torch.profiler`` the NCCL calls on
    the host and NCCL's ranges on the device's timeline (one rank runs an all-reduce as a no-op and an
    all-gather as one device copy, launching no NCCL kernel); (b)
    certified solves against HiGHS: ``tests/test_sharded.py``'s 8192 x 192
    LP (at least 150 iterations), its tall bounded LPs (statuses equal to
    ``BatchedSimplexSolver``'s) and its 16,384-row LP (not escalated);
    (c) BASELINE config 5's generator cut to ``SHARDED_ROWS`` rows,
    certified, its wall split into assembly, staging, solve, extract and
    certify, and its peak device memory; (d)
    ``utils/sharded_bench.bench_sharded(10240, 64, 3, compare_size=8192)``
    (K1 launched 256 times by its comparison) and one chunk of 32 pivots
    under ``torch.profiler``: NCCL calls a pivot, their and the update's
    share of the device time, the busy share; (e) ``python -m
    simplex_tpu_torch.utils.sharded_cards --ranks 1 --phases abc`` (the
    runner of solves across cards, as one rank: its collectives, its loop
    through graphs against eager chunks, its layout against HiGHS) must
    exit 0.  The sharded solves launch no kernel of the port.  The
    sharded loop's steps stop at the verdict too: (c) and (d) log its
    steps against its iterations (``[loop-exit]``), equal, and (c) holds
    the 32,768-row solve through graphs bit-equal to its eager solve;
21. the measurement runner ``python -m simplex_tpu_torch.bench``, one
    subprocess a mode (``BENCH_MODES``): the default mode (phase 13's
    pivot rate with the four batched sub-benches of phases 8 and 11),
    ``--batch`` at 16,384, ``--solve-dense`` (phase 5's LP), ``--pdhg``
    (phase 17's cell), ``--sharded`` (phase 20's 10240), ``--stream`` at
    250,000 (one chunk) and ``--stream-exact`` at 262,144 (phases 18 and
    19's cuts); each must exit 0 and print one JSON line, logged as
    ``[bench]``, and pass its gate;
22. many users at once (``[load]`` lines), every request through the web
    app, whose report keeps ``LOAD_HISTORY`` pivots
    (``SIMPLEX_TPU_MAX_HISTORY``): users of the form on the three anchors
    (``/new`` and ``/solve``) and users who upload one of eight
    netlib-scale MPS files (``/load`` and ``/solve``; ``web_netlib_mps``:
    ``generate_netlib_adversarial`` with its free columns boxed, as the
    web's ``/load`` takes them).  Each request is first served alone
    (anchors at their known Z, the LPs within 1e-6 (1+|z|) of HiGHS, read
    from the saved report), and each library call of (c) alone.  Then (a)
    16 users at once on ``TestClient``s of one ``init_app()`` (14 on the
    form, 2 uploads), twice, then 20 s of 4 arrivals a second (one in 16
    an upload); (b) 8 users over HTTP (6 on the form, 2 uploads; ``urllib``
    with cookie jars, against ``simplex_tpu_torch.web_app.app`` behind a
    threading ``wsgiref`` server on a free local port); every answer of
    (a) and (b) must equal the request's alone (no status >= 500, no
    flashed solve error); (c) 4 threads each calling ``solve_lp`` on a
    distinct 2048^2 LP (phase 5's generator, seeds 0-3), one of them also
    ``solve_arrays`` on phase 8's batch, and a fifth thread a
    ``solve_arrays_stream`` sweep of 4 x 16384 LPs beside their captures:
    each result bit-equal to the call alone, K1's and K2's launches the
    solo runs' sums.  Logs latencies (p50, p95, max), captures and replays
    a request, the cache's entries and bytes, peak device memory and host
    RSS growth.

Every solve loop runs each chunk of device steps as one replayed CUDA graph
(``simplex_tpu_torch/runtime/graphs.py``).  Phases 5, 8, 11, 14, 15, 16,
17 and 20 also run their loops through the eager chunks (the module's
private switch) and hold the two bit-equal: the loops' tableaus, bases,
statuses, iterations and pivots (and ``at_upper``, ``B_inv``, PDHG's x and
y), with the kernels' launches equal; each logs both times (``[graphs]``)
and, for phases 5, 14, 17 and 20, both busy shares under
``torch.profiler`` (``[graphs-busy]``).  After each of those phases the
graph cache logs its entries, their capture seconds and their bytes on the
card (``[graphs-cache]``).

A chunk's steps stop at the loop's verdict, as the reference's
``lax.while_loop`` does: in a replayed graph the steps after a chunk's
first are the body of a WHILE conditional node, and no kernel runs after
the step that gave the verdict.  Phases 5, 8, 11, 14 (b), 16 and 20 log each
loop's launches (the revised engine's steps) against that bound beside
its seconds both ways and the figures from before (``[loop-exit]``), and
fail past it: K1 at most one launch a pivot plus one a chunk (phases 5
and 16), K2 and K3 exactly one an iteration (phases 8 and 11), the
revised engine at most its iterations plus one step a chunk (phase 14 b),
the sharded loop exactly one step an iteration (phase 20).

Each kernel's record gives its time at the main path's largest shape, its
plain twin's, the bound (the bytes a step must move over 3.35 TB/s, or its
operations over the float32 peak, whichever is larger; counted from what
the kernel must read and write for the timed step's own outcome), and the time of one PyTorch call that computes the
same function where there is one.  The line before the last holds the
card's name and power limit as ``nvidia-smi`` prints them; the line before
that the kernel record (JSON); the last line is ``{"ok": true, "device":
{...}}``.
"""
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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


# The card's published peaks (H100 SXM data sheet, dense): memory and
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _bound_ms(nbytes, flops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _step_bytes(M, N, itemsize, pivot, flip, state_bytes):
    """Bytes one batched step must move with this run's data: a pivoting
    instance reads and writes its whole tableau; a flipping one reads its
    objective row, the entering column and the RHS column and writes the
    RHS column; any other reads what decides that it stops (the objective
    row, the entering column and the RHS column).  ``pivot`` and ``flip``
    are bool tensors over the instances; ``state_bytes`` is every other
    input read once and output written once."""
    n_piv = int(pivot.sum())
    n_flip = int(flip.sum())
    n_rest = pivot.numel() - n_piv - n_flip
    elems = n_piv * 2 * M * N + n_flip * (N + 3 * M) + n_rest * (N + 2 * M)
    return elems * itemsize + state_bytes


def _eligible(torch, T, cm1, cm2, phase, at_upper=None, tol=1e-6):
    """Per instance, how many columns pricing finds eligible: those whose
    Devex weight a step that does not pivot must read."""
    cm = torch.where((phase == 1)[:, None], cm1, cm2)
    rc = T[:, -1, :]
    if at_upper is None:
        return (cm & (rc < -tol)).sum(1)
    up = torch.cat([at_upper, torch.zeros_like(at_upper[:, :1])], 1)
    return (cm & torch.where(up, rc > tol, rc < -tol)).sum(1)


def _state_bytes(M, N, itemsize, pivot, flip, optimal, eligible, bland,
                 devex, bounded, art_rows=None):
    """Bytes of every input but T that one K2 or K3 step must read once and
    every output it must write once, from this run's outcome (bool tensors
    over the instances; ``eligible`` from :func:`_eligible`):

    * every instance: phase, status and bland (9 B), the mask of its own
      phase (N), s, r and the three flags (11 B);
    * Devex: the weights of the eligible columns, or on a pivot all N
      lanes read and written;
    * the basis: the row, for Bland's tie (not optimal); else basis[r] on
      a pivot (the leaving column: Devex in K2, at_upper in K3); basis[r]
      written on a pivot;
    * bounded (K3): at_upper read (N-1), ub[s], ub_B read (M-1); on a pivot
      ub_B[r] and at_upper of the leaving and the entering column written;
      on a flip at_upper[s];
    * ``art_rows`` (K3 with ``with_art``: the phase-2 instances) is_art_row
      read (M-1); on a pivot art_mask[s] read and is_art_row[r] written.
    """
    R = M - 1
    piv, flp = pivot.long(), flip.long()
    per = 9 + N + 11 + 4 * piv
    if devex:
        per = per + itemsize * (eligible * (1 - piv) + 2 * N * piv)
    leaving = 4 * piv if devex or bounded else 0 * piv
    per = per + (bland & ~optimal).long() * (4 * R - leaving) + leaving
    if bounded:
        per = per + (N - 1) + itemsize * (1 + R) + (itemsize + 2) * piv + flp
    if art_rows is not None:
        per = per + R * art_rows.long() + 2 * piv
    return int(per.sum())


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


def _chain_ms(torch, fn, n=64, reps=5):
    """``fn`` launched ``n`` times back to back between two CUDA events,
    ``reps`` times after one warm-up chain: the ms a launch of each chain,
    and the host's enqueue ms a launch (where that reaches the device time,
    the chain is bound by the host)."""
    fn()
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / n)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / n)
    return dev, host


K1_SHAPES = [(257, 300), (257, 301), (2304, 4608), (10240, 10240),
             (10241, 10241)]
# (shape, elements the base lies past a 16-byte boundary)
K1_VIEWS = [((257, 301), 1), ((2304, 4608), 1)]


def phase_k1(torch, pivot_kernel):
    """K1 against its twin at the main path's shapes and on views whose
    base is off a 16-byte boundary, f32 and f64; returns the worst absolute
    difference seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def idx(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    def flag(v):
        return torch.full((), v, dtype=torch.bool, device=dev)

    def placed(T0, offset):
        """A copy of T0 as a view ``offset`` elements into its buffer."""
        buf = torch.empty(T0.numel() + offset, dtype=T0.dtype, device=dev)
        view = buf[offset:].view(T0.shape)
        view.copy_(T0)
        return view

    worst = 0.0
    cases = [(shape, 0) for shape in K1_SHAPES] + K1_VIEWS
    for dtype in (torch.float32, torch.float64):
        for (R, W), offset in cases:
            T0 = torch.randn((R, W), generator=gen, device=dev, dtype=dtype)
            T0[:, -1] = T0[:, -1].abs()
            T0[1, -1] = -1e-3            # a negative RHS lane for the clamp
            tmax = float(T0.abs().max())
            where = f"{R}x{W} {dtype}" + (f", base {offset} element(s) "
                                           f"past 16 B" if offset else "")
            shape_err = 0.0
            for clamp in (False, True):
                for r, s in [(0, 0), (1, 1), (R // 2, W // 3),
                             (R - 1, W - 2)]:
                    got = placed(T0, offset)
                    pivot_kernel.pivot_update_(got, idx(r), idx(s),
                                               flag(True), clamp_rhs=clamp)
                    ref = pivot_kernel.pivot_update_ref(
                        T0.clone(), idx(r), idx(s), flag(True),
                        clamp_rhs=clamp)
                    torch.cuda.synchronize()
                    shape_err = max(shape_err,
                                    float((got - ref).abs().max()))
                    torch.testing.assert_close(got, ref, rtol=1e-6,
                                               atol=1e-6 * tmax)
                    check(torch.equal(got[r], ref[r]),
                          f"K1 row {r} differs at {where}")
                    check(torch.equal(got[:, s], ref[:, s]),
                          f"K1 column {s} differs at {where}")
            same = placed(T0, offset)
            pivot_kernel.pivot_update_(same, idx(3), idx(4), flag(False),
                                       clamp_rhs=True)
            torch.cuda.synchronize()
            check(torch.equal(same, T0), f"do_pivot=0 changed T at {where}")
            log(f"[k1] {where}: matches twin (clamp on/off, 4 pivots, "
                f"do_pivot=0 no-op), max_abs_err={shape_err!r}")
            worst = max(worst, shape_err)
            del T0, got, ref, same
    return worst


def phase_k1_timing(torch, pivot_kernel, gpu):
    """ms per pivot of K1, of its twin, of torch's own copy (the card's
    streaming yardstick) and of ``addr_``, the one PyTorch call closest to
    K1's function (``T - col (outer) prow``, without K1's row and column
    writes and the RHS clamp): one launch (median of 20) and chained (64
    launches between two events, five chains; ``addr_``, K1, K1, ``addr_``
    in turns, the two chains of each pooled).  Returns {(R, W): dict}.
    10241^2 is the pivot-rate tableau, whose rows start off the 16-byte
    boundary."""
    dev = torch.device("cuda")
    out = {}
    for R, W in [(2304, 4608), (10240, 10240), (10241, 10241)]:
        T = torch.randn((R, W), device=dev)
        dst = torch.empty_like(T)
        r = torch.full((), R // 2, dtype=torch.int64, device=dev)
        s = torch.full((), W // 3, dtype=torch.int64, device=dev)
        go = torch.full((), True, dtype=torch.bool, device=dev)
        col, prow = T[:, W // 3].clone(), T[R // 2].clone()
        nbytes = 2 * R * W * 4

        def k1():
            pivot_kernel.pivot_update_(T, r, s, go, clamp_rhs=True)

        def addr():
            T.addr_(col, prow, alpha=-1.0)

        t = {"one": _time_ms(k1),
             "twin": _time_ms(lambda: pivot_kernel.pivot_update_ref(
                 T, r, s, go, clamp_rhs=True)),
             "copy_": _time_ms(lambda: dst.copy_(T)),
             "addr_one": _time_ms(addr)}
        a1, ah1 = _chain_ms(torch, addr)
        k1a, kh1 = _chain_ms(torch, k1)
        k1b, kh2 = _chain_ms(torch, k1)
        a2, ah2 = _chain_ms(torch, addr)
        t["chain"] = statistics.median(k1a + k1b)
        t["chain_spread"] = (max(k1a + k1b) - min(k1a + k1b)) / t["chain"]
        t["host"] = statistics.median(kh1 + kh2)
        t["addr_chain"] = statistics.median(a1 + a2)
        t["addr_host"] = statistics.median(ah1 + ah2)
        t["bound"], t["bound_by"] = _bound_ms(nbytes, 2 * R * W)
        resident = (f" ({nbytes / 2e6} MB: L2-resident, the bound "
                    f"assumes HBM)") if nbytes / 2 < 50e6 else ""
        log(f"[k1-time] {R}x{W} f32 on {gpu}: K1 one launch {t['one']!r} "
            f"ms, chained {t['chain']!r} ms/pivot (spread "
            f"{t['chain_spread']!r}; host enqueue {t['host']!r} ms a "
            f"launch; {nbytes / t['chain'] / 1e6!r} GB/s at 2*R*W*4 B); "
            f"torch addr_ one launch {t['addr_one']!r} ms, chained "
            f"{t['addr_chain']!r} ms (host enqueue {t['addr_host']!r} ms); "
            f"K1/addr_ chained {t['chain'] / t['addr_chain']!r}; twin "
            f"{t['twin']!r} ms/pivot, torch copy_ {t['copy_']!r} ms "
            f"({nbytes / t['copy_'] / 1e6!r} GB/s); bound {t['bound']!r} ms "
            f"({t['bound_by']}){resident}")
        out[(R, W)] = t
        del T, dst, col, prow
    return out


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


def dense_lp(size, seed=0):
    """The LP of bench.py::bench_dense_solve (same generator; its seed is
    0)."""
    rng = np.random.default_rng(seed)
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

    from simplex_tpu_torch.ops import tableau

    pivot_kernel.LAUNCHES = 0
    tableau.STATE_READS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve_lp(lp, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, chunks = pivot_kernel.LAUNCHES, tableau.STATE_READS

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

    # The chunks as replayed graphs against the eager chunks: the loop's
    # tableau, basis, status and iterations bit for bit, K1's launches
    # equal to the timed run's.
    def run():
        pivot_kernel.LAUNCHES = 0
        with _Timed(tableau, "solve_tableau", torch, keep=True) as loop:
            r = pt.solve_lp(lp, cfg)
        T, basis, status, iters = loop.kept[-1][2]
        return ({"T": T, "basis": basis, "status": status, "iters": iters,
                 "x": r.x, "K1": pivot_kernel.LAUNCHES},
                {"solve_tableau": loop.seconds()})

    times, out = _versus(torch, "phase 5, the 2048x2048 solve_lp", run, gpu)
    check(out["K1"] == launches, f"K1 launches {out['K1']} in the graph and "
          f"eager runs, {launches} in the timed run")
    for kind in ("graph", "eager"):
        secs = times[kind]["solve_tableau"]
        log(f"[graphs] phase 5 solve_tableau {kind} on {gpu}: {secs!r} s = "
            f"{[out['iters'] / t for t in secs]!r} pivots/s")
    # A chunk stops after the step that gives its verdict: one K1 launch a
    # pivot and one a chunk.
    check(not res.escalated, "the 2048 solve escalated")
    _loop_exit("phase 5", f"K1 launches for {res.nit} pivots in {chunks} "
               "chunks", launches, res.nit + chunks,
               {k: v["solve_tableau"] for k, v in times.items()}, gpu)
    args, kw, _ = loop_args(tableau, lambda: pt.solve_lp(lp, cfg))
    _busy(torch, "phase 5 solve_tableau", lambda: tableau.solve_tableau(
        *args, **kw), gpu)
    return launches, res.basis


def loop_args(module, fn, name="solve_tableau"):
    """The arguments and result of the last call of ``module.name`` while
    ``fn()`` runs."""
    with _Timed(module, name, keep=True) as rec:
        fn()
    return rec.kept[-1]


MIXED_OPS = np.array([-1, -1, -1, -1, 1, 1, 0, 0, -1])


def random_batch(seed, B, m, n, mixed):
    """A batch like ``tests/test_pallas_batched.py::_random_batch``; with
    ``mixed``, a third of the instances keep all-``<=`` rows (phase 2 from
    the start) and the rest cycle the mixed operators (phase 1 first)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 2.0, (B, m, n))
    c = rng.uniform(0.5, 3.0, (B, n))
    b = rng.uniform(5.0, 25.0, (B, m))
    ops = np.full((B, m), -1)
    if mixed:
        ops[np.arange(B) % 3 != 0] = np.resize(MIXED_OPS, m)
    return c, A, b, ops


def _ulps(a, b):
    """Per-element distance in units in the last place (float tensors)."""
    import torch

    ib = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    top = torch.iinfo(ib).max

    def key(x):
        i = x.view(ib).to(torch.int64) if ib == torch.int32 else x.view(ib)
        return torch.where(i < 0, -(i & top), i)
    return (key(a) - key(b)).abs()


# Cases of phases 6 and 9: (B, m, n, mixed rows, dtype, (row_pad,
# col_pad)).  The compiler's default padding gives 16x128 (9x13), 32x128
# (30x50) and 64x256 (60x100) tableaus; 100x150 in float32 (104x384,
# 156 KB) and 200x300 in float64 (208x768, 1.25 MB) lie above the kernels'
# 64 KB staging budget (csrc/batched_step_common.cuh), so their update
# streams; unpadded 8x12 (9x29) and 8x14 (9x23) tiles are not a whole number
# of 16-byte vectors, so every instance but the first starts off a 16-byte
# boundary and is staged by cp.async with a scalar head and tail.
STEP_CASES = [(16, 9, 13, True, np.float32, (8, 128)),
              (16, 9, 13, True, np.float64, (8, 128)),
              (1024, 30, 50, False, np.float32, (8, 128)),
              (16384, 30, 50, False, np.float32, (8, 128)),
              (64, 60, 100, True, np.float32, (8, 128)),
              (8, 100, 150, True, np.float32, (8, 128)),
              (8, 200, 300, True, np.float64, (8, 128)),
              (64, 8, 12, True, np.float32, (1, 1)),
              (64, 8, 12, True, np.float64, (1, 1)),
              (64, 8, 14, False, np.float32, (1, 1))]


def _where(B, M, N, dtype):
    tile = M * N * np.dtype(dtype).itemsize
    kind = "streamed" if tile > 64 * 1024 else "staged"
    odd = ", not a 16-byte multiple" if tile % 16 else ""
    return f"{B}x{M}x{N} {np.dtype(dtype).name} ({tile} B a tile, {kind}{odd})"


def phase_k2(torch, bk, compile_batch_uniform):
    """K2 against its twin: eight successive steps from the same state,
    outputs, flags and basis equal, T and w 0 ulps from the twin (equal up
    to the sign of a zero), inactive instances bit-identical; returns the
    worst absolute difference seen."""
    dev = torch.device("cuda")
    worst = 0.0
    for B, m, n, mixed, dtype, pad in STEP_CASES:
        cb = compile_batch_uniform(*random_batch(B + m, B, m, n, mixed),
                                   maximize=True, dtype=dtype,
                                   row_pad=pad[0], col_pad=pad[1])
        for devex in (False, True):
            T = torch.as_tensor(cb.T0, device=dev).contiguous()
            _, M, N = T.shape
            basis = torch.as_tensor(cb.basis, device=dev).contiguous()
            zero = torch.zeros((B, 1), dtype=torch.bool, device=dev)
            cm1 = torch.cat([torch.as_tensor(cb.col_mask_p1, device=dev),
                             zero], 1)
            cm2 = torch.cat([torch.as_tensor(cb.col_mask_p2, device=dev),
                             zero], 1)
            phase = torch.as_tensor(np.where(cb.need_p1, 1, 2),
                                    dtype=torch.int32, device=dev)
            status = torch.full((B,), -1, dtype=torch.int32, device=dev)
            status[::5] = 0                       # not running
            bland = torch.arange(B, device=dev) % 2 == 0
            w = torch.ones((B, N), dtype=T.dtype, device=dev)
            err = 0.0
            max_ulp = 0
            for step in range(8):
                twin = [x.clone() for x in (T, basis, w)]
                before = T.clone()
                out_k = bk.fused_pivot_step_(T, basis, cm1, cm2, phase,
                                             status, bland, w, tol=1e-6,
                                             devex=devex)
                out_t = bk.fused_pivot_step_ref(twin[0], twin[1], cm1, cm2,
                                                phase, status, bland,
                                                twin[2], tol=1e-6,
                                                devex=devex)
                torch.cuda.synchronize()
                where = f"{_where(B, M, N, dtype)} devex={devex} step {step}"
                for name, a, b in zip(("s", "r", "optimal", "unbounded",
                                       "did_pivot"), out_k[3:], out_t[3:]):
                    check(torch.equal(a, b), f"K2 {name} differs, {where}")
                check(torch.equal(basis, twin[1]), f"K2 basis, {where}")
                did = out_k[7]
                check(torch.equal(T[~did], before[~did]),
                      f"K2 changed an inactive instance, {where}")
                check(bool(did.any()) or step > 0, f"no pivot, {where}")
                ulp = max(int(_ulps(T, twin[0]).max()),
                          int(_ulps(w, twin[2]).max()))
                check(ulp == 0, f"K2 T/w {ulp} ulps from the twin, {where}")
                max_ulp = max(max_ulp, ulp)
                err = max(err, float((T - twin[0]).abs().max()),
                          float((w - twin[2]).abs().max()))
            log(f"[k2] {where.rsplit(' step', 1)[0]}: 8 steps match the "
                f"twin (s, r, flags, basis equal; T and w {max_ulp} ulps "
                f"from it), max_abs_err={err!r}")
            worst = max(worst, err)
        del cb
    return worst


CHAIN_STEPS = 16


def _profiled(torch, fn):
    """``fn()`` under ``torch.profiler``: its wall seconds and, for every
    kernel and copy on the device, (device us, count, name).  An aten op's
    record, on the host or as the profiler's annotation of it on the
    device's timeline, spans the device time of what it launched, which is
    counted already, so those are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA \
                or ev.key.startswith("aten::"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            events.append((us, ev.count, ev.key))
    return wall, events


def _device_ms(torch, fn, key):
    """``fn()`` under ``torch.profiler``: the device ms a launch of the
    kernels whose name holds ``key``, and their count."""
    hits = [(us, n) for us, n, name in _profiled(torch, fn)[1] if key in name]
    us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    return (us / 1e3 / n if n else float("nan")), n


def _step_chains(torch, sk, step, reset, T, n=CHAIN_STEPS, reps=5):
    """``n`` successive steps of a batched kernel from the batch's first
    state (``reset`` restores it before each chain, outside the events)
    between two CUDA events, in turns with chains of ``n`` torch ``copy_``s
    of the tableau ``T`` into a spare buffer and ``n`` K4 passes in place on
    a copy of it (forward order in even rounds, backward in odd ones), one
    warm-up round and ``reps`` timed ones.  Returns {name: (device ms a
    call, host enqueue ms a call)} lists for "kernel", "copy_" and "k4"."""
    dst = torch.empty_like(T)
    x = T.clone()

    def kernel():
        for _ in range(n):
            step()

    def copy():
        for _ in range(n):
            dst.copy_(T)

    def k4():
        for _ in range(n):
            sk.stream_copy_(x)

    runs = {"kernel": kernel, "copy_": copy, "k4": k4}
    out = {name: ([], []) for name in runs}
    for rnd in range(reps + 1):
        order = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
        for name in order:
            if name == "kernel":
                reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            runs[name]()
            host = (time.perf_counter() - t0) * 1e3 / n
            end.record()
            end.synchronize()
            if rnd:
                out[name][0].append(start.elapsed_time(end) / n)
                out[name][1].append(host)
    del dst, x
    return out


def _chain_report(torch, name, B, M, N, chains, step_bytes, flops, profiled,
                  stopped, gpu):
    """Log the chained times of a kernel against its bound (the mean of its
    ``n`` steps' own bytes) and against ``copy_`` and K4 moving the same
    bytes, with ``profiled`` (the device ms a launch of one more chain under
    the profiler, and the launches it saw) and ``stopped`` (ms of one
    launch with every instance stopped, and its bound); returns the
    numbers."""
    med = {k: statistics.median(v[0]) for k, v in chains.items()}
    dev = chains["kernel"][0]
    t = {"chain": med["kernel"],
         "chain_spread": (max(dev) - min(dev)) / med["kernel"],
         "host": statistics.median(chains["kernel"][1]),
         "copy_": med["copy_"], "k4": med["k4"]}
    t["chain_bound"], t["chain_bound_by"] = _bound_ms(step_bytes, flops)
    whole = 2 * B * M * N * 4
    t["copy_same"] = med["copy_"] * step_bytes / whole
    t["k4_same"] = med["k4"] * step_bytes / whole
    t["device"], n_prof = profiled
    t["stopped"], t["stopped_bound"] = stopped
    log(f"[{name}-chain] B={B} {M}x{N} f32 Devex on {gpu}: {CHAIN_STEPS} "
        f"steps from the first tableau, median of {len(dev)}: "
        f"{t['chain']!r} ms a step (spread {t['chain_spread']!r}; host "
        f"enqueue {t['host']!r} ms a call); bound {t['chain_bound']!r} ms "
        f"({t['chain_bound_by']}, {step_bytes!r} B a step, the mean of the "
        f"{CHAIN_STEPS} steps' own) = {t['chain_bound'] / t['chain']!r} of "
        f"it; "
        f"torch copy_ of the tableau {med['copy_']!r} ms a call "
        f"({whole / med['copy_'] / 1e6!r} GB/s), of the same bytes "
        f"{t['copy_same']!r} ms = {t['copy_same'] / t['chain']!r} of "
        f"{name.upper()}'s time; K4 in place {med['k4']!r} ms a call, the "
        f"same bytes {t['k4_same']!r} ms = {t['k4_same'] / t['chain']!r}")
    log(f"[{name}-chain] B={B} on {gpu}: one more chain under "
        f"torch.profiler: {t['device']!r} ms of device time a launch "
        f"({n_prof} launches) = {t['chain_bound'] / t['device']!r} of the "
        f"bound, {t['copy_same'] / t['device']!r} of copy_'s time for the "
        f"same bytes; one launch with every instance stopped (the late "
        f"steps of a solve): {t['stopped']!r} ms against a "
        f"{t['stopped_bound']!r} ms bound")
    return t


def phase_k2_timing(torch, bk, sk, compile_batch_uniform, gpu):
    """ms per step of K2, of its twin and of torch's ``copy_`` of the same
    (B, 32, 128) f32 tableau: one launch from the batch's first tableau
    (median of 20), then chained (:func:`_step_chains`).  Returns {B: dict
    of the times and bounds}."""
    dev = torch.device("cuda")
    out = {}
    for B in (1024, 16384):
        cb = compile_batch_uniform(*random_batch(7, B, 30, 50, False),
                                   maximize=True)
        T0 = torch.as_tensor(cb.T0, device=dev).contiguous()
        _, M, N = T0.shape
        basis0 = torch.as_tensor(cb.basis, device=dev).contiguous()
        cm = torch.cat([torch.as_tensor(cb.col_mask_p2, device=dev),
                        torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                       1)
        phase = torch.full((B,), 2, dtype=torch.int32, device=dev)
        status = torch.full((B,), -1, dtype=torch.int32, device=dev)
        bland = torch.zeros((B,), dtype=torch.bool, device=dev)
        T, basis = T0.clone(), basis0.clone()
        w = torch.ones((B, N), device=dev)
        dst = torch.empty_like(T0)

        def reset():
            T.copy_(T0)
            basis.copy_(basis0)
            w.fill_(1.0)

        def timed(step):
            return _one_launch_ms(torch, step, reset)

        args = (T, basis, cm, cm, phase, status, bland, w)
        k_ms = timed(lambda: bk.fused_pivot_step_(*args, devex=True))
        p_ms = timed(lambda: bk.fused_pivot_step_ref(*args, devex=True))
        c_ms = timed(lambda: dst.copy_(T))
        nbytes = 2 * B * M * N * 4
        # The bound, from the timed step's own outcome.
        reset()
        elig = _eligible(torch, T, cm, cm, phase)
        res = bk.fused_pivot_step_(*args, devex=True)
        did, no_flip = res[7], torch.zeros_like(res[7])
        state = _state_bytes(M, N, 4, did, no_flip, res[5], elig, bland,
                             devex=True, bounded=False)
        step_bytes = _step_bytes(M, N, 4, did, no_flip, state)
        b_ms, b_by = _bound_ms(step_bytes, 2 * M * N * int(did.sum()))
        resident = ", L2-resident: the bound assumes HBM" \
            if B * M * N * 4 < 50e6 else ""
        log(f"[k2-time] B={B} {M}x{N} f32 Devex on {gpu}: K2 {k_ms!r} "
            f"ms/step ({nbytes / k_ms / 1e6!r} GB/s at 2*B*M*N*4 B), twin "
            f"{p_ms!r} ms/step, torch copy_ {c_ms!r} ms "
            f"({nbytes / c_ms / 1e6!r} GB/s); K2 = {c_ms / k_ms!r} of copy_; "
            f"bound {b_ms!r} ms ({b_by}, {step_bytes} B{resident}), "
            f"K2 = {b_ms / k_ms!r} of it")
        one = dict(one=k_ms, twin=p_ms, bound=b_ms, bound_by=b_by)
        # The chained bound: this run's 16 steps, untimed (the kernel is
        # deterministic, so the timed chains take the same steps).
        reset()
        total, flops = 0, 0
        for _ in range(CHAIN_STEPS):
            elig = _eligible(torch, T, cm, cm, phase)
            res = bk.fused_pivot_step_(*args, devex=True)
            did = res[7]
            state = _state_bytes(M, N, 4, did, no_flip, res[5], elig, bland,
                                 devex=True, bounded=False)
            total += _step_bytes(M, N, 4, did, no_flip, state)
            flops += 2 * M * N * int(did.sum())
        chains = _step_chains(
            torch, sk, lambda: bk.fused_pivot_step_(*args, devex=True), reset,
            T)
        reset()
        profiled = _device_ms(torch, lambda: [
            bk.fused_pivot_step_(*args, devex=True)
            for _ in range(CHAIN_STEPS)], "fused_pivot_step_kernel")
        # Every instance stopped: each reads what decides its s, r and
        # flags, and writes nothing else.
        stopped = torch.zeros_like(status)
        reset()
        elig = _eligible(torch, T, cm, cm, phase)
        nothing = torch.zeros_like(did)
        optimal = bk.fused_pivot_step_ref(T.clone(), basis.clone(), cm, cm,
                                          phase, stopped, bland, w.clone(),
                                          devex=True)[5]
        state = _state_bytes(M, N, 4, nothing, nothing, optimal, elig, bland,
                             devex=True, bounded=False)
        s_args = (T, basis, cm, cm, phase, stopped, bland, w)
        s_ms = timed(lambda: bk.fused_pivot_step_(*s_args, devex=True))
        s_bound = _bound_ms(_step_bytes(M, N, 4, nothing, nothing, state),
                            0)[0]
        one.update(_chain_report(torch, "k2", B, M, N, chains,
                                 total / CHAIN_STEPS, flops / CHAIN_STEPS,
                                 profiled, (s_ms, s_bound), gpu))
        out[B] = one
        del T0, T, dst, cb
    return out


def bench_batch(B, m=30, n=50):
    """The batch of ``bench.py::bench_batched_solve`` (same generator and
    seed): dense feasible ``Ax <= b`` with ``b > 0``, maximized."""
    rng = np.random.default_rng(0)
    A = rng.uniform(0.05, 1.0, size=(B, m, n)).astype(np.float32)
    b = rng.uniform(1.0, 5.0, size=(B, m)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, size=(B, n)).astype(np.float32)
    return c, A, b, np.full((m,), -1)


def _highs(c, A, b, ops, maximize):
    """(status, z) of HiGHS on one LP (presolve off: with it, HiGHS may
    call an unbounded LP infeasible)."""
    from scipy.optimize import linprog

    le, ge, eq = ops == -1, ops == 1, ops == 0
    A_ub = np.vstack([A[le], -A[ge]])
    b_ub = np.concatenate([b[le], -b[ge]])
    ref = linprog(-c if maximize else c,
                  A_ub=A_ub if len(b_ub) else None,
                  b_ub=b_ub if len(b_ub) else None,
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=b[eq] if eq.any() else None,
                  method="highs", options={"presolve": False})
    z = None if ref.status != 0 else (-ref.fun if maximize else ref.fun)
    return ref.status, z


def _gate(z_ref, z):
    return abs(z - z_ref) <= 1e-6 * (1.0 + abs(z_ref))


def phase_batched(torch, pt, bk, ck, gpu, B=16384):
    """The batched path through its entry point; returns the K2 launches
    of the full-width solve and :func:`phase_certify`'s dict."""
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device="cuda"))
    c, A, b, ops = bench_batch(B)
    warm = solver.solve_arrays(*bench_batch(256), maximize=True)
    check(bool(np.all(warm.status == 0)), "warm-up batch not all optimal")

    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    ck.LAUNCHES_CERT = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True)
    wall = time.perf_counter() - t0
    launches_full, nit_full = bk.LAUNCHES, res.nit
    check(ck.LAUNCHES_CERT == 1, f"the certifier kernel launched "
          f"{ck.LAUNCHES_CERT}x in the certified solve, not once")
    from simplex_tpu_torch.utils import profiling

    fallback = profiling.recent("batched.solve_arrays")[-1]["counts"] \
        .get("certify_fallback")
    check(fallback is not None, "the solve record holds no "
          "certify_fallback count")

    check(res.status.shape == (B,) and bool(np.all(res.status == 0)),
          f"{int(np.sum(res.status != 0))} of {B} instances not optimal")
    check(res.certified is not None and bool(np.all(res.certified)),
          "not every instance certified")
    check(bool(np.all(np.isfinite(res.x))) and res.x.shape == (B, 50),
          "x not finite")
    pmax = int(res.pivots.max())
    check(launches_full >= pmax,
          f"K2 launches {launches_full} < max pivots {pmax}")
    sample = np.random.default_rng(1).choice(B, size=256, replace=False)
    t1 = time.perf_counter()
    for i in sample:
        st, z = _highs(c[i].astype(np.float64), A[i].astype(np.float64),
                       b[i].astype(np.float64), ops, True)
        check(st == 0 and _gate(z, res.z[i]),
              f"instance {i}: z={res.z[i]!r}, HiGHS {z!r} (status {st})")
    highs_s = time.perf_counter() - t1
    log(f"[batched] {B} x (30x50) on {gpu}: all status 0 and certified, "
        f"escalated={res.n_escalated}, device solve {res.solve_time!r} s "
        f"(with syncs), end-to-end wall {wall!r} s = {B / wall!r} LPs/s, "
        f"pivots mean {float(res.pivots.mean())!r} max {pmax}, nit "
        f"{res.nit}, K2 launches {launches_full}, certifier launches 1 "
        f"({fallback} instances left to the host copy); z within "
        f"1e-6(1+|z|) of HiGHS on 256 sampled ({highs_s!r} s on the host)")
    cert = phase_certify(torch, ck, res, c, A, b, fallback, gpu)
    _profile_solve(torch, lambda: solver.solve_arrays(c, A, b, ops,
                                                      maximize=True),
                   "fused_pivot_step_kernel", "K2", "batched", gpu)

    Bm = 1024
    c, A, b, ops, maximize = mixed_batch(Bm)
    before = bk.LAUNCHES
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=maximize)
    wall = time.perf_counter() - t0
    check(bk.LAUNCHES > before, "the mixed batch launched K2 no time")
    mixed_launches, mixed_nit = bk.LAUNCHES - before, res.nit
    counts = {}
    for i in range(Bm):
        st, z = _highs(c[i], A[i], b[i], ops[i], bool(maximize[i]))
        check(int(res.status[i]) == st,
              f"mixed instance {i}: status {res.status[i]}, HiGHS {st}")
        if st == 0:
            check(_gate(z, res.z[i]),
                  f"mixed instance {i}: z={res.z[i]!r}, HiGHS {z!r}")
        counts[st] = counts.get(st, 0) + 1
    log(f"[batched] {Bm} x (30x50) mixed <=/=/>= through the two-phase "
        f"loop: statuses equal HiGHS on all ({counts}), z within the gate "
        f"on the optimal ones, escalated={res.n_escalated}, wall {wall!r} s, "
        f"pivots mean {float(res.pivots.mean())!r} max "
        f"{int(res.pivots.max())}, K2 launches {bk.LAUNCHES - before}")
    mixed_times, _ = _versus(torch, "phase 8, the 1024 x (30x50) mixed "
                             "batch", _batch_run(torch, bk, solver,
                                                 (c, A, b, ops),
                                                 dict(maximize=maximize)),
                             gpu)
    c, A, b, ops = bench_batch(B)
    times, out = _versus(torch, f"phase 8, the {B} x (30x50) batch",
                         _batch_run(torch, bk, solver, (c, A, b, ops),
                                    dict(maximize=True)), gpu)
    check(out["K2"] == launches_full and out["K3"] == 0,
          f"K2 launches {out['K2']} in the graph and eager runs, "
          f"{launches_full} in the timed run")
    # The steps stop at the first with no instance running (the
    # reference's icond): one K2 launch an iteration.
    _loop_exit("phase 8", f"K2 launches for {nit_full} iterations",
               launches_full, nit_full,
               {k: v["_solve_loop"] for k, v in times.items()}, gpu,
               exact=True)
    _loop_exit("phase 8 mixed", f"K2 launches for {mixed_nit} iterations "
               "of the two-phase loop (1024 mixed)", mixed_launches,
               mixed_nit, {k: v["_solve_loop"] for k, v in
                           mixed_times.items()}, gpu, exact=True)
    return launches_full, cert


# H100 SXM's float64 rate without tensor cores (the certifier's arithmetic).
F64_FLOPS = 34e12


def _flushed_ms(torch, fn, reps=20, warmup=3):
    """Median ms of one ``fn()`` between two CUDA events, a 256 MB buffer
    written before each, outside the events, so that nothing ``fn`` reads
    is left in the 50 MB L2."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    times = []
    for k in range(warmup + reps):
        flush.fill_(float(k))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if k >= warmup:
            times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def phase_certify(torch, ck, res, c, A, b, fallback, gpu, ub=None):
    """The certifier kernel (``csrc/certify_bounded.cu``) on a solve's
    claims: phase 8's without bounds, phase 11 (b)'s with ``ub`` and
    ``at_upper``.  One failure of each kind is planted (``_plant`` of
    ``tests/test_torch_certify_kernel.py``, with bounds of
    ``tests/test_torch_certify_bounded.py``), and the kernel is checked
    against its twin on the card: flags equal, ``x`` and ``fun`` within
    1e-12 (1 + |twin|), every planted instance uncertified, with bounds the
    one with ``at_upper`` on a basic column certified, and no other
    uncertified but the ``fallback`` the solve left to the host.  Then the
    kernel timed one launch after an L2 flush and chained (64 launches),
    and the twin, beside the kernel's bound.  Returns the kernels line's
    numbers."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_certify_bounded
    import test_torch_certify_kernel

    from simplex_tpu_torch.models.batched import _CERT_TOL

    B, m, n = A.shape
    maxi = np.ones(B, bool)
    res = dataclasses.replace(res, basis=np.array(res.basis, np.int32),
                              status=np.array(res.status, np.int32))
    if ub is None:
        b, planted = test_torch_certify_kernel._plant(res, c, A, b, maxi)
        kept, bounds, where = [], (), f"phase 8's {B} x ({m}x{n}) solve"
    else:
        res.at_upper = np.array(res.at_upper)
        b, planted, (ign, _) = test_torch_certify_bounded._plant(
            res, c, A, b, ub, maxi)
        kept, bounds = [ign], (ub, res.at_upper)
        where = (f"phase 11 (b)'s {B} x ({m}x{n}) solve, ub and at_upper "
                 f"(on a basic column of {ign})")
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in
            (A, b, c, maxi, res.basis, res.status)] + [_CERT_TOL] \
        + [torch.as_tensor(a, device=dev) for a in bounds]
    ck.LAUNCHES_CERT = 0
    ok, x, fun = ck.certify_le_(*args)
    rok, rx, rfun = ck.certify_le_ref(*args)
    torch.cuda.synchronize()
    check(ck.LAUNCHES_CERT == 1, f"certify_le_ launched "
          f"{ck.LAUNCHES_CERT}x, not once")
    check(torch.equal(ok, rok), f"certified differs from the twin on "
          f"{int((ok != rok).sum())} instances")
    check(not bool(ok[planted].any()) and bool(ok[kept].all())
          and int(ok.sum()) >= B - len(planted) - fallback,
          f"planted {planted}, kept {kept}: the kernel certified "
          f"{int(ok.sum())} of {B}")
    err = 0.0
    for got, want in ((x, rx), (fun, rfun)):
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              "NaN patterns differ from the twin")
        got, want = got.nan_to_num(), want.nan_to_num()
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= 1e-12 * (1 + want.abs())).all()),
              f"x or fun beyond 1e-12 (1 + |twin|) of the twin: {err!r}")
    # What the kernel must move: A, b, c, maximize, ub (the wrapper's one
    # +inf row without bounds), the basis's m columns and the status read,
    # at_upper's n columns read where given; x, fun and the flags written.
    ub_bytes = args[7].numel() * args[7].element_size() if bounds else n * 4
    nbytes = sum(t.numel() * t.element_size() for t in args[:4]) \
        + ub_bytes + B * m * 4 + B * 4 + (B * n if bounds else 0) \
        + ok.numel() + x.numel() * 8 + fun.numel() * 8
    flops = B * (2 * m ** 3 / 3 + 4 * m * m + (4 if bounds else 2) * m * n)
    # The main path's launches: one a solve_arrays call (phases 8, 11 (b)).
    t = {"launches": 1, "err": err, "shape": (B, m, n),
         "twin": _time_ms(lambda: ck.certify_le_ref(*args), warmup=1,
                          reps=5),
         "one": _flushed_ms(torch, lambda: ck.certify_le_(*args))}
    chained, _ = _chain_ms(torch, lambda: ck.certify_le_(*args))
    t["chained"] = statistics.median(chained)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOPS * 1e3
    t["bound"], t["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                 else (t_ops, "operations"))
    log(f"[certify] certify_le_ on {where} on {gpu}, failures planted in "
        f"instances {planted}: flags equal to the twin, {int(ok.sum())} "
        f"certified, x and fun within {err!r} of it; kernel {t['one']!r} "
        f"ms one launch after an L2 flush, {t['chained']!r} ms a launch "
        f"chained (64), twin {t['twin']!r} ms; bound {t['bound']!r} ms "
        f"({t['bound_by']}: {nbytes / 1e6!r} MB, {flops / 1e9!r} GFLOP "
        f"float64) = {t['bound'] / t['one']!r} of the flushed launch, "
        f"{t['bound'] / t['chained']!r} of the chained")
    return t


def _batch_run(torch, bk, solver, args, kw):
    """A ``run()`` for :func:`_versus`: ``solver.solve_arrays(*args,
    **kw)``, with its solve loop's outputs, the certified results, the K2
    and K3 launches, and the loop's and the device solve's seconds."""
    from simplex_tpu_torch.ops import batched as tops

    def run():
        bk.LAUNCHES = bk.LAUNCHES_K3 = 0
        with _Timed(tops, "_solve_loop", torch, keep=True) as loop:
            r = solver.solve_arrays(*args, **kw)
        # The solve's own loop: a bounded float32 batch runs the float64
        # finish's loops after it.
        T, basis, at_up, status, iters, pivots = loop.kept[0][2][:6]
        out = {"T": T, "basis": basis, "status": status, "iters": iters,
               "pivots": pivots, "x": r.x, "z": r.z,
               "certified": r.certified, "K2": bk.LAUNCHES,
               "K3": bk.LAUNCHES_K3}
        if at_up is not None:
            out["at_upper"] = at_up
        return out, {"_solve_loop": loop.seconds(),
                     "solve_time": r.solve_time}
    return run


def bounded_ub(seed, B, n):
    """``bench.py::bench_bounded_batched``'s bounds: 60 % of the variables
    bounded, ``ub`` from U(1, 3)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((B, n)) < 0.6, rng.uniform(1.0, 3.0, (B, n)),
                    np.inf)


class BoundedState:
    """K3's inputs on the card for a bounded compiled batch: phase-1
    instances where the batch has them, ``status``/``bland`` as given."""

    def __init__(self, torch, cb, status, bland):
        dev = torch.device("cuda")
        self.T = torch.as_tensor(cb.T0, device=dev).contiguous()
        B, M, N = self.T.shape
        self.basis = torch.as_tensor(cb.basis, device=dev).contiguous()
        zero = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        cm1 = torch.as_tensor(cb.col_mask_p1, device=dev)
        cm2 = torch.as_tensor(cb.col_mask_p2, device=dev)
        self.cm1 = torch.cat([cm1, zero], 1)
        self.cm2 = torch.cat([cm2, zero], 1)
        self.art = torch.cat([cm1 & ~cm2, zero], 1)
        self.phase = torch.as_tensor(np.where(cb.need_p1, 1, 2),
                                     dtype=torch.int32, device=dev)
        self.status, self.bland = status, bland
        self.ub = torch.as_tensor(cb.ub_ext, device=dev).contiguous()
        bl = self.basis.long()
        self.ub_B = self.ub.gather(1, bl).contiguous()
        self.is_art_row = self.art.gather(1, bl).contiguous()
        self.at_upper = torch.zeros((B, N - 1), dtype=torch.bool, device=dev)
        self.w = torch.ones((B, N), dtype=self.T.dtype, device=dev)

    STATE = ("T", "basis", "at_upper", "w", "ub_B", "is_art_row")

    def args(self):
        return (self.T, self.basis, self.at_upper, self.cm1, self.cm2,
                self.phase, self.status, self.bland, self.w, self.ub,
                self.ub_B, self.is_art_row, self.art)

    def clone(self):
        other = BoundedState.__new__(BoundedState)
        other.__dict__.update(self.__dict__)
        for k in self.STATE:
            setattr(other, k, getattr(self, k).clone())
        return other


def _k3_against_twin(torch, bk, k, kw, where, steps=8):
    """``steps`` successive steps of K3 and of its twin from the state
    ``k`` (a :class:`BoundedState`, which K3 advances): outputs, flags and
    the bound state equal, T, w and ub_B 0 ulps from the twin (equal up to
    the sign of a zero), instances that do not move bit-identical.  Returns
    the worst absolute difference, the most ulps, and the flips, pivots
    and entries from an upper bound among the steps."""
    err, max_ulp, flips, pivots, from_up = 0.0, 0, 0, 0, 0
    for step in range(steps):
        t, before = k.clone(), k.clone()
        out_k = bk.fused_pivot_step_bounded_(*k.args(), **kw)
        out_t = bk.fused_pivot_step_bounded_ref(*t.args(), **kw)
        torch.cuda.synchronize()
        at = f"{where} step {step}"
        for name, a, b in zip(("s", "r", "optimal", "unbounded",
                               "moving"), out_k[6:], out_t[6:]):
            check(torch.equal(a, b), f"K3 {name} differs, {at}")
        for name in ("basis", "at_upper", "is_art_row"):
            check(torch.equal(getattr(k, name), getattr(t, name)),
                  f"K3 {name} differs, {at}")
        moving = out_k[10]
        for name in BoundedState.STATE:
            check(torch.equal(getattr(k, name)[~moving],
                              getattr(before, name)[~moving]),
                  f"K3 changed {name} of a still instance, {at}")
        ulp = max(int(_ulps(getattr(k, x), getattr(t, x)).max())
                  for x in ("T", "w", "ub_B"))
        check(ulp == 0, f"K3 T/w/ub_B {ulp} ulps from the twin, {at}")
        max_ulp = max(max_ulp, ulp)
        for x in ("T", "w", "ub_B"):
            d = (getattr(k, x) - getattr(t, x)).abs()
            err = max(err, float(torch.nan_to_num(d).max()))
        flip = moving & (k.basis == before.basis).all(1)
        s = out_k[6].long()[:, None]
        up = before.at_upper.gather(1, s)[:, 0]
        flips += int(flip.sum())
        pivots += int((moving & ~flip).sum())
        from_up += int((moving & ~flip & up).sum())
        del t, before
    return err, max_ulp, flips, pivots, from_up


def phase_k3(torch, bk, compile_batch_uniform):
    """K3 against its twin: three twin steps put columns at their upper
    bounds, then eight successive steps from the same state
    (:func:`_k3_against_twin`); at least one flip and one entry from an
    upper bound over all cases.  Returns the worst absolute difference."""
    dev = torch.device("cuda")
    # Phase 6's cases and the general (two-phase) driver's shape.
    cases = STEP_CASES[:3] + [(1024, 30, 50, True, np.float32, (8, 128))] \
        + STEP_CASES[3:]
    worst = 0.0
    total_flips = total_from_up = 0
    for B, m, n, mixed, dtype, pad in cases:
        cb = compile_batch_uniform(*random_batch(B + m, B, m, n, mixed),
                                   maximize=True, dtype=dtype,
                                   ub=bounded_ub(B + m + 1, B, n),
                                   row_pad=pad[0], col_pad=pad[1])
        status = torch.full((B,), -1, dtype=torch.int32, device=dev)
        status[::5] = 0                       # not running
        bland = torch.arange(B, device=dev) % 2 == 0
        for devex in (False, True):
            k = BoundedState(torch, cb, status, bland)
            _, M, N = k.T.shape
            kw = dict(tol=1e-6, devex=devex, with_art=mixed)
            for _ in range(3):
                bk.fused_pivot_step_bounded_ref(*k.args(), **kw)
            where = f"{_where(B, M, N, dtype)} devex={devex}"
            err, max_ulp, flips, _, from_up = _k3_against_twin(
                torch, bk, k, kw, where)
            log(f"[k3] {where}: 8 steps match the twin (s, r, flags, basis, "
                f"at_upper, is_art_row equal; T, w and ub_B {max_ulp} ulps "
                f"from it), {flips} flips, {from_up} entries from an upper "
                f"bound, max_abs_err={err!r}")
            worst = max(worst, err)
            total_flips += flips
            total_from_up += from_up
        del cb
    check(total_flips > 0 and total_from_up > 0,
          f"the bounded machinery did not run: {total_flips} flips, "
          f"{total_from_up} entries from an upper bound")
    return worst


def phase_k3_timing(torch, bk, sk, compile_batch_uniform, gpu):
    """ms per step of K3, of its twin and of torch's ``copy_`` of the same
    (B, 32, 128) f32 tableau: one launch from the batch's first state
    (median of 20; the bound from that step's own outcome), then chained
    (:func:`_step_chains`).  Returns {B: dict of the times and bounds}."""
    dev = torch.device("cuda")
    out = {}
    for B in (1024, 16384):
        c, A, b, ops = bench_batch(B)
        cb = compile_batch_uniform(c, A, b, ops, maximize=True,
                                   ub=bounded_ub(5, B, 50))
        status = torch.full((B,), -1, dtype=torch.int32, device=dev)
        bland = torch.zeros((B,), dtype=torch.bool, device=dev)
        first = BoundedState(torch, cb, status, bland)
        st = first.clone()
        _, M, N = st.T.shape
        dst = torch.empty_like(st.T)

        def reset():
            for name in BoundedState.STATE:
                getattr(st, name).copy_(getattr(first, name))

        def timed(step):
            return _one_launch_ms(torch, step, reset)

        kw = dict(devex=True, with_art=False)
        k_ms = timed(lambda: bk.fused_pivot_step_bounded_(*st.args(), **kw))
        p_ms = timed(lambda: bk.fused_pivot_step_bounded_ref(*st.args(),
                                                             **kw))
        c_ms = timed(lambda: dst.copy_(st.T))
        reset()
        elig = _eligible(torch, st.T, st.cm1, st.cm2, st.phase, st.at_upper)
        res = bk.fused_pivot_step_bounded_(*st.args(), **kw)
        moving = res[10]
        flip = moving & (st.basis == first.basis).all(1)
        pivot = moving & ~flip
        # with_art is off: no art-exit rows, so no is_art_row or art_mask.
        state = _state_bytes(M, N, 4, pivot, flip, res[8], elig, bland,
                             devex=True, bounded=True)
        step_bytes = _step_bytes(M, N, 4, pivot, flip, state)
        b_ms, b_by = _bound_ms(step_bytes, 2 * M * N * int(pivot.sum()))
        nbytes = 2 * B * M * N * 4
        resident = ", L2-resident: the bound assumes HBM" \
            if B * M * N * 4 < 50e6 else ""
        log(f"[k3-time] B={B} {M}x{N} f32 Devex on {gpu}: K3 {k_ms!r} "
            f"ms/step ({nbytes / k_ms / 1e6!r} GB/s at 2*B*M*N*4 B), twin "
            f"{p_ms!r} ms/step, torch copy_ {c_ms!r} ms; the timed step: "
            f"{int(pivot.sum())} pivots, {int(flip.sum())} flips; bound "
            f"{b_ms!r} ms ({b_by}, {step_bytes} B{resident}), K3 = "
            f"{b_ms / k_ms!r} of it")
        one = dict(one=k_ms, twin=p_ms, bound=b_ms, bound_by=b_by)
        reset()
        total, flops = 0, 0
        for _ in range(CHAIN_STEPS):
            elig = _eligible(torch, st.T, st.cm1, st.cm2, st.phase,
                             st.at_upper)
            basis_before = st.basis.clone()
            res = bk.fused_pivot_step_bounded_(*st.args(), **kw)
            moving = res[10]
            flip = moving & (st.basis == basis_before).all(1)
            pivot = moving & ~flip
            state = _state_bytes(M, N, 4, pivot, flip, res[8], elig, bland,
                                 devex=True, bounded=True)
            total += _step_bytes(M, N, 4, pivot, flip, state)
            flops += 2 * M * N * int(pivot.sum())
        chains = _step_chains(
            torch, sk, lambda: bk.fused_pivot_step_bounded_(*st.args(), **kw),
            reset, st.T)
        reset()
        profiled = _device_ms(torch, lambda: [
            bk.fused_pivot_step_bounded_(*st.args(), **kw)
            for _ in range(CHAIN_STEPS)], "fused_pivot_step_bounded")
        # Every instance stopped: each reads what decides its s, r and
        # flags, and writes nothing else.
        reset()
        st.status = torch.zeros_like(status)
        elig = _eligible(torch, st.T, st.cm1, st.cm2, st.phase, st.at_upper)
        nothing = torch.zeros_like(moving)
        optimal = bk.fused_pivot_step_bounded_ref(*st.clone().args(),
                                                  **kw)[8]
        state = _state_bytes(M, N, 4, nothing, nothing, optimal, elig, bland,
                             devex=True, bounded=True)
        s_ms = timed(lambda: bk.fused_pivot_step_bounded_(*st.args(), **kw))
        s_bound = _bound_ms(_step_bytes(M, N, 4, nothing, nothing, state),
                            0)[0]
        st.status = status
        one.update(_chain_report(torch, "k3", B, M, N, chains,
                                 total / CHAIN_STEPS, flops / CHAIN_STEPS,
                                 profiled, (s_ms, s_bound), gpu))
        out[B] = one
        del first, st, dst, cb
    return out


def bench_bounded_batch(B, m=30, n=50):
    """The batch of ``bench.py::bench_bounded_batched`` (same generator and
    seed): ``bench_batch``'s LPs with 60 % of the variables bounded."""
    rng = np.random.default_rng(0)
    A = rng.uniform(0.05, 1.0, size=(B, m, n)).astype(np.float32)
    b = rng.uniform(1.0, 5.0, size=(B, m)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, size=(B, n)).astype(np.float32)
    ub = np.where(rng.random((B, n)) < 0.6,
                  rng.uniform(1.0, 3.0, (B, n)), np.inf).astype(np.float32)
    return c, A, b, np.full((m,), -1), ub


def general_bounded_lp(seed, rows=(3, 9), boxes=True):
    """``tests/test_bounds.py::_random_bounded_lp``'s LP as keyword
    arguments: rows that hold at a random point, and per variable one of
    [0, inf), free, a box, (-inf, u] and [l, inf) with l possibly negative;
    ``boxes=False`` leaves the boxes out, so no upper bound survives
    ``normalize_bounds``."""
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(*rows)), int(rng.integers(3, 11))
    A = rng.normal(size=(m, n)).round(2)
    x0 = rng.uniform(-1, 3, size=n)
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3]).astype(np.int8)
    slack = rng.uniform(0.1, 1.0, size=m)
    b = A @ x0 + np.where(ops == -1, slack, np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=n).round(2)
    kind = rng.integers(0, 5, size=n)
    if not boxes:
        kind = np.where(kind == 2, 4, kind)
    lb, ub = np.zeros(n), np.full(n, np.inf)
    for j in range(n):
        if kind[j] == 1:
            lb[j] = -np.inf
        elif kind[j] == 2:
            lb[j] = round(x0[j] - rng.uniform(0, 2), 2)
            ub[j] = round(x0[j] + rng.uniform(0, 2), 2)
        elif kind[j] == 3:
            lb[j], ub[j] = -np.inf, round(x0[j] + rng.uniform(0, 2), 2)
        elif kind[j] == 4:
            lb[j] = round(x0[j] - rng.uniform(0, 2), 2)
    return dict(c=c, A=A, b=b, ops=ops, maximize=bool(rng.integers(0, 2)),
                lb=lb, ub=ub)


def _highs_bounded(c, A, b, ops, maximize, lb, ub):
    """(status, z) of HiGHS on one LP with bounds, presolve off."""
    from scipy.optimize import linprog

    le, ge, eq = ops == -1, ops == 1, ops == 0
    A_ub = np.vstack([A[le], -A[ge]])
    b_ub = np.concatenate([b[le], -b[ge]])
    bounds = [(None if np.isneginf(lo) else float(lo),
               None if np.isinf(hi) else float(hi)) for lo, hi in zip(lb, ub)]
    ref = linprog(-c if maximize else c,
                  A_ub=A_ub if len(b_ub) else None,
                  b_ub=b_ub if len(b_ub) else None,
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=b[eq] if eq.any() else None, bounds=bounds,
                  method="highs", options={"presolve": False})
    z = None if ref.status != 0 else (-ref.fun if maximize else ref.fun)
    return ref.status, z


def _profile_bounded(torch, pt, tmb, c, A, b, ops, ub, gpu):
    """Where the bounded solve's time goes: its stages on the host clock
    (with a sync at each edge), then one more solve under
    ``torch.profiler``: device busy share of the wall, K3's share of the
    device time."""
    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = tmb.compile_batch_on_device(c, A, b, ops, True, ub=ub,
                                     device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = solver._solve_compiled(cb)
    t2 = time.perf_counter()
    tmb.certify_uniform_result(res, c, A, b, ops, True, ub=ub)
    t3 = time.perf_counter()
    log(f"[bounded-stages] on {gpu}: wall {t3 - t0!r} s = assembly "
        f"{t1 - t0!r} s + _run_batch {t2 - t1!r} s + certify_uniform_result "
        f"{t3 - t2!r} s (certifier {(t3 - t2) / (t3 - t0)!r} of the wall)")
    _profile_solve(torch, lambda: solver.solve_arrays(c, A, b, ops,
                                                      maximize=True, ub=ub),
                   "fused_pivot_step_bounded", "K3", "bounded", gpu)


def _profile_solve(torch, solve, key, kernel, name, gpu):
    """One more ``solve()`` under ``torch.profiler``: device busy share of
    the wall, and the share of the device time in kernels whose name holds
    ``key`` (``kernel`` names them in the log)."""
    wall, top = _profiled(torch, solve)
    dev_us = sum(us for us, _, _ in top)
    k_us = sum(us for us, _, name in top if key in name)
    k_n = sum(n for _, n, name in top if key in name)
    if dev_us == 0:
        log(f"[{name}-profile] the profiler saw no device time")
        return
    top.sort(reverse=True)
    log(f"[{name}-profile] on {gpu}: wall {wall!r} s (under the profiler), "
        f"device time {dev_us / 1e3!r} ms = {dev_us / 1e6 / wall!r} of the "
        f"wall; {kernel} {k_us / 1e3!r} ms over {k_n} launches = "
        f"{k_us / dev_us!r} of the device time")
    for us, n, ev_key in top[:6]:
        log(f"[{name}-profile]   {us / 1e3!r} ms, {n} calls: {ev_key[:90]}")


def phase_bounded(torch, pt, bk, gpu, B=16384):
    """The bounded path through its entry points; returns the K3 launches
    of the full-width solve."""
    from simplex_tpu_torch.models import batched as tmb
    from simplex_tpu_torch.utils import profiling

    solver = pt.BatchedSimplexSolver(pt.SolverConfig(device="cuda"))
    c, A, b, ops, ub = bench_bounded_batch(B)
    cw, Aw, bw, opsw, ubw = bench_bounded_batch(256)
    warm = solver.solve_arrays(cw, Aw, bw, opsw, maximize=True, ub=ubw)
    check(bool(np.all(warm.status == 0)), "bounded warm-up not all optimal")

    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True, ub=ub)
    wall = time.perf_counter() - t0
    k3_launches, k2_launches, nit_full = bk.LAUNCHES_K3, bk.LAUNCHES, res.nit
    # The float64 finish launches K3 after the loop (all-<= batches).
    finish = profiling.recent("batched.solve_arrays")[-1]["counts"].get(
        "finish_launches", 0)

    check(res.status.shape == (B,) and bool(np.all(res.status == 0)),
          f"{int(np.sum(res.status != 0))} of {B} bounded instances not "
          f"optimal")
    check(res.certified is not None and bool(np.all(res.certified)),
          "not every bounded instance certified")
    check(res.at_upper is not None and bool(res.at_upper.any()),
          "no column ended at its upper bound")
    check(bool(np.all(np.isfinite(res.x))) and res.x.shape == (B, 50),
          "x not finite")
    check(bool(np.all(res.x <= ub + 1e-5)), "x above its upper bound")
    pmax = int(res.pivots.max())
    check(k3_launches >= pmax,
          f"K3 launches {k3_launches} < max pivots {pmax}")
    check(k2_launches == 0, f"the bounded solve launched K2 {k2_launches}x")
    sample = np.random.default_rng(1).choice(B, size=256, replace=False)
    t1 = time.perf_counter()
    lb0 = np.zeros(50)
    for i in sample:
        st, z = _highs_bounded(c[i].astype(np.float64),
                               A[i].astype(np.float64),
                               b[i].astype(np.float64), ops, True, lb0,
                               ub[i].astype(np.float64))
        check(st == 0 and _gate(z, res.z[i]),
              f"bounded instance {i}: z={res.z[i]!r}, HiGHS {z!r} "
              f"(status {st})")
    highs_s = time.perf_counter() - t1
    log(f"[bounded] {B} x (30x50), 60 % bounded, on {gpu}: all status 0 "
        f"and certified, escalated={res.n_escalated}, "
        f"{int(res.at_upper.any(1).sum())} instances end with columns at "
        f"upper, device solve {res.solve_time!r} s (with syncs), end-to-end "
        f"wall {wall!r} s = {B / wall!r} LPs/s, pivots (and flips) mean "
        f"{float(res.pivots.mean())!r} max {pmax}, nit {res.nit}, K3 "
        f"launches {k3_launches}; z within 1e-6(1+|z|) of HiGHS on 256 "
        f"sampled ({highs_s!r} s on the host)")
    _profile_bounded(torch, pt, tmb, c, A, b, ops, ub, gpu)

    Bm = 1024
    c, A, b, ops, ub = mixed_bounded_batch(Bm)
    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=False, ub=ub)
    wall = time.perf_counter() - t0
    check(bk.LAUNCHES_K3 > 0, "the mixed bounded batch launched K3 no time")
    mixed_launches, mixed_nit = bk.LAUNCHES_K3, res.nit
    counts = {}
    for i in range(Bm):
        st, z = _highs_bounded(c[i], A[i], b[i], ops, False, np.zeros(50),
                               ub[i])
        check(int(res.status[i]) == st,
              f"mixed bounded instance {i}: status {res.status[i]}, HiGHS "
              f"{st}")
        if st == 0:
            check(_gate(z, res.z[i]),
                  f"mixed bounded instance {i}: z={res.z[i]!r}, HiGHS {z!r}")
        counts[st] = counts.get(st, 0) + 1
    log(f"[bounded] {Bm} x (30x50) mixed <=/=/>= rows, bounded, through the "
        f"two-phase loop: statuses equal HiGHS on all ({counts}), z within "
        f"the gate on the optimal ones, escalated={res.n_escalated}, wall "
        f"{wall!r} s, pivots mean {float(res.pivots.mean())!r} max "
        f"{int(res.pivots.max())}, K3 launches {bk.LAUNCHES_K3}")
    mixed_times, _ = _versus(
        torch, "phase 11, the 1024 x (30x50) mixed bounded batch",
        _batch_run(torch, bk, solver, (c, A, b, ops),
                   dict(maximize=False, ub=ub)), gpu)
    cB, AB, bB, opsB, ubB = bench_bounded_batch(B)
    times, out = _versus(torch, f"phase 11, the bounded {B} x (30x50) "
                         "batch", _batch_run(torch, bk, solver,
                                             (cB, AB, bB, opsB),
                                             dict(maximize=True, ub=ubB)),
                         gpu)
    check(out["K3"] == k3_launches and out["K2"] == 0,
          f"K3 launches {out['K3']} in the graph and eager runs, "
          f"{k3_launches} in the timed run")
    _loop_exit("phase 11", f"K3 launches (less the float64 finish's "
               f"{finish}) for {nit_full} iterations",
               k3_launches - finish, nit_full,
               {k: v["_solve_loop"] for k, v in times.items()}, gpu,
               exact=True)
    _loop_exit("phase 11 mixed", f"K3 launches for {mixed_nit} iterations "
               "of the two-phase loop (1024 mixed)", mixed_launches,
               mixed_nit, {k: v["_solve_loop"] for k, v in
                           mixed_times.items()}, gpu, exact=True)

    # The sweep: shapes and bound kinds mixed; the 224 LPs with boxes keep
    # finite upper bounds (K3), the 32 taller ones without boxes form a
    # bucket with none (K2).
    kws = [general_bounded_lp(s) for s in range(1000, 1224)] + \
        [general_bounded_lp(s, rows=(9, 17), boxes=False)
         for s in range(2000, 2032)]
    lps = [pt.LinearProgram(**kw) for kw in kws]
    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    t0 = time.perf_counter()
    out = pt.solve_lp_sweep(lps, pt.SolverConfig(device="cuda"))
    wall = time.perf_counter() - t0
    check(bk.LAUNCHES > 0 and bk.LAUNCHES_K3 > 0,
          f"the sweep launched K2 {bk.LAUNCHES}x and K3 "
          f"{bk.LAUNCHES_K3}x; both must run")
    counts = {}
    for i, (kw, (x, z, st, ok)) in enumerate(zip(kws, out)):
        st_ref, z_ref = _highs_bounded(kw["c"], kw["A"], kw["b"], kw["ops"],
                                       kw["maximize"], kw["lb"], kw["ub"])
        check(st == st_ref, f"sweep LP {i}: status {st}, HiGHS {st_ref}")
        if st_ref == 0:
            check(ok and _gate(z_ref, z),
                  f"sweep LP {i}: z={z!r}, HiGHS {z_ref!r}")
            check(bool(np.all(x >= kw["lb"] - 1e-6))
                  and bool(np.all(x <= kw["ub"] + 1e-6)),
                  f"sweep LP {i}: x outside its bounds")
        counts[st] = counts.get(st, 0) + 1
    log(f"[sweep] {len(lps)} LPs of mixed shapes with general bounds: "
        f"statuses and objectives equal HiGHS on all ({counts}), wall "
        f"{wall!r} s, K2 launches {bk.LAUNCHES}, K3 launches "
        f"{bk.LAUNCHES_K3}")
    return k3_launches


# The batched-step skeleton stages an instance's tile in shared memory only
# up to this many bytes (kStageMaxBytes, csrc/batched_step_common.cuh);
# a larger tile decides from global memory and streams its update.
STAGE_MAX_BYTES = 64 * 1024
# The mknapcb9.relax cell's seed for phase 11 (b)'s draw (a large one, as
# the benchmark's are).
MKNAP_SEED = 2654435761
# K3 steps that take phase 11 (b)'s tableaus from their first state to one
# with pivots and bound flips both under way.
MKNAP_ADVANCE = 200


def mknap_batch(B, m=30, n=500, seed=MKNAP_SEED):
    """Item 0 of the ``mknapcb9.relax`` cell's traffic
    (``lpbench/traffic/mknap.py``, Chu & Beasley's law) for ``seed``, cut
    to ``B`` LPs of ``m`` x ``n``."""
    from lpbench.traffic import mknap

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lpbench", "traffic", "mknap_relax.json")
    with open(path, encoding="utf-8") as f:
        traffic = json.load(f)
    traffic.update(batch=B, m=m, n=n, dtype="float32")
    return mknap.item(traffic, seed, 0)


def _one_launch_ms(torch, step, reset, reps=20, warmup=3):
    """Median ms of one ``step()`` between two CUDA events, ``reset()``
    restoring its first state before each, outside the events."""
    times = []
    for k in range(warmup + reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        if k >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_mknap(torch, pt, bk, ck, compile_batch_uniform, gpu, B=16384,
                m=30, n=500):
    """Phase 11 (b): the ``mknapcb9.relax`` cell's path.  ``solve_arrays``
    on a draw of its traffic (``ub`` = 1, all ``<=``, float32, certified):
    K3 launched once an iteration of the loop plus the float64 finish's
    launches, the certifier kernel once, every answer optimal and
    certified, ``x`` in its bounds and ``at_upper`` equal to ``x`` at its
    bound, flips counted, 512 answers against the plain bounded reference
    (``lpbench/reference/bounded.py``); the certifier on the solve's
    claims with ``ub`` and ``at_upper`` (:func:`phase_certify`).
    Then K3 against its twin (:func:`_k3_against_twin`) on the draw's
    float32 tableau (B, 32, 640) and on a float64 one at the finish's chunk
    (4096, 32, 640), both above the stage bound, so every instance streams:
    from the first state advanced ``MKNAP_ADVANCE`` K3 steps, eight steps,
    flips and pivots among them; then one launch of each timed from that
    state, with its bound.  Returns {dtype name: the kernels line's
    numbers} and :func:`phase_certify`'s dict."""
    from lpbench.reference import bounded as reference
    from simplex_tpu_torch.models import batched as tmb
    from simplex_tpu_torch.ops import batched as tops
    from simplex_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    item = mknap_batch(B, m, n)
    c, A, b, ub = item["c"], item["A"], item["b"], item["ub"]
    ops = np.full(m, -1)
    cfg = pt.SolverConfig(device="cuda", dtype="float32", certify=True)
    solver = pt.BatchedSimplexSolver(cfg)

    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    ck.LAUNCHES_CERT = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True, ub=ub)
    wall = time.perf_counter() - t0
    k3_launches, k2_launches = bk.LAUNCHES_K3, bk.LAUNCHES
    counts = profiling.recent("batched.solve_arrays")[-1]["counts"]
    finish = counts.get("finish_launches", 0)
    fallback = counts.get("certify_fallback")
    check(k2_launches == 0, f"the MKP solve launched K2 {k2_launches}x")
    check(ck.LAUNCHES_CERT == 1, f"the MKP solve launched the certifier "
          f"{ck.LAUNCHES_CERT}x, not once")
    check(fallback is not None, "the MKP solve record holds no "
          "certify_fallback count")
    check(k3_launches == res.nit + finish,
          f"the MKP solve launched K3 {k3_launches}x: {res.nit} iterations "
          f"and {finish} in the float64 finish")
    check(bool(np.all(res.status == 0)),
          f"{int(np.sum(res.status != 0))} of {B} MKP LPs not optimal")
    check(bool(np.all(res.certified)), "not every MKP LP certified")
    check(bool(np.all(res.x >= -1e-6)) and bool(np.all(res.x <= 1 + 1e-5)),
          "an MKP x outside [0, 1]")
    up = res.at_upper[:, :n]
    check(bool(up.any()) and bool(np.all(np.abs(res.x[up] - 1.0) <= 1e-9)),
          "at_upper names a variable that is not at its bound")
    flips = int(res.flips.sum())
    check(flips > 0 and bool(np.all(res.flips <= res.pivots)),
          f"flips {flips}, not counted among the steps")
    check(counts.get("bound_flips") == flips,
          f"the record counts {counts.get('bound_flips')} flips, the loop "
          f"{flips}")
    sample = np.random.default_rng(1).choice(B, size=min(512, B),
                                             replace=False)
    ref = reference.solve(c[sample], A[sample], b[sample], ub[sample],
                          device="cuda")
    check(bool(np.all(ref["status"] == 0)), "the reference not optimal")
    gap = np.abs(res.z[sample] - ref["z"]) / (1.0 + np.abs(ref["z"]))
    check(float(gap.max()) <= 1e-6,
          f"MKP z {float(gap.max())!r} from the reference (relative)")
    log(f"[mknap] {B} x ({m}x{n}), ub = 1, float32 on {gpu}: all status 0 "
        f"and certified, escalated={res.n_escalated} (at_upper reset "
        f"{counts.get('at_upper_reset', 0)}), wall {wall!r} s (graphs "
        f"captured in it), steps mean {float(res.pivots.mean())!r} max "
        f"{int(res.pivots.max())}, of them flips {flips} "
        f"({flips / max(int(res.pivots.sum()), 1)!r}), nit {res.nit}; K3 "
        f"launches {k3_launches} = {res.nit} + the finish's {finish} "
        f"({counts.get('finish_steps', 0)} finish steps); the "
        f"certifier launches 1 ({fallback} instances left to the host "
        f"copy); z within {float(gap.max())!r} (relative) of the plain "
        f"reference on {len(sample)} sampled")
    cert = phase_certify(torch, ck, res, c, A, b, fallback, gpu, ub=ub)
    del res, solver, ref

    out = {}
    for dtype, Bk in ((np.float32, B), (np.float64, min(tops._FINISH_CHUNK,
                                                         B))):
        name = np.dtype(dtype).name
        cb = compile_batch_uniform(c[:Bk], A[:Bk], b[:Bk], ops, maximize=True,
                                   dtype=dtype, ub=ub[:Bk])
        status = torch.full((Bk,), -1, dtype=torch.int32, device=dev)
        bland = torch.arange(Bk, device=dev) % 2 == 0
        k = BoundedState(torch, cb, status, bland)
        del cb
        _, M, N = k.T.shape
        itemsize = np.dtype(dtype).itemsize
        tile = M * N * itemsize
        check(tile > STAGE_MAX_BYTES,
              f"the {name} {M}x{N} tile ({tile} B) is staged, not streamed")
        kw = dict(tol=tmb._batch_tol(cfg, dtype), devex=True, with_art=False)
        for _ in range(MKNAP_ADVANCE):
            bk.fused_pivot_step_bounded_(*k.args(), **kw)
        first = k.clone()
        where = f"B={Bk} {M}x{N} {name} ({tile} B a tile, streamed)"
        err, max_ulp, flips, pivots, from_up = _k3_against_twin(
            torch, bk, k, kw, where)
        check(flips > 0 and pivots > 0,
              f"K3 on the MKP {name} tableau: {flips} flips, {pivots} "
              f"pivots; both must happen")
        st = first.clone()

        def reset():
            for x in BoundedState.STATE:
                getattr(st, x).copy_(getattr(first, x))

        k_ms = _one_launch_ms(
            torch, lambda: bk.fused_pivot_step_bounded_(*st.args(), **kw),
            reset)
        p_ms = _one_launch_ms(
            torch, lambda: bk.fused_pivot_step_bounded_ref(*st.args(), **kw),
            reset)
        reset()
        elig = _eligible(torch, st.T, st.cm1, st.cm2, st.phase, st.at_upper)
        res = bk.fused_pivot_step_bounded_(*st.args(), **kw)
        moving = res[10]
        flip = moving & (st.basis == first.basis).all(1)
        pivot = moving & ~flip
        state = _state_bytes(M, N, itemsize, pivot, flip, res[8], elig, bland,
                             devex=True, bounded=True)
        b_ms, b_by = _bound_ms(_step_bytes(M, N, itemsize, pivot, flip,
                                           state),
                               2 * M * N * int(pivot.sum()))
        log(f"[mknap-k3] {where} Devex on {gpu}, after {MKNAP_ADVANCE} "
            f"steps: 8 steps match the twin (s, r, flags, basis, at_upper "
            f"equal; T, w and ub_B {max_ulp} ulps from it), {pivots} pivots, "
            f"{flips} flips, {from_up} entries from an upper bound, "
            f"max_abs_err={err!r}; one launch {k_ms!r} ms, twin {p_ms!r} ms, "
            f"bound {b_ms!r} ms ({b_by}; the timed step {int(pivot.sum())} "
            f"pivots, {int(flip.sum())} flips) = {b_ms / k_ms!r} of K3's")
        out[name] = dict(shape=(Bk, M, N), err=err, one=k_ms, twin=p_ms,
                         bound=b_ms, bound_by=b_by,
                         launches=(k3_launches - finish if dtype == np.float32
                                   else finish))
        del k, first, st, res
    torch.cuda.empty_cache()
    return out, cert


K4_SHAPES = [(10241, 10241),      # the pivot-rate tableau, (size+1)^2
             (10304, 10368),      # bench.py's tile-rounded copy shape
             (16384, 32, 128),    # K2's and K3's batched tableau
             (257, 300)]


def phase_k4(torch, sk):
    """K4 against its twin, bit for bit: in place and out of place, f32
    and f64, at ``K4_SHAPES``, and on a view one element into each (out of
    place into an aligned buffer: every element on the scalar loop; in
    place: the scalar head and tail around the vectors).  Values span
    1e-9..1e3, so the add rounds every way.  Returns the worst absolute
    difference (0.0 when every check holds)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for shape in K4_SHAPES:
            scale = 10.0 ** torch.randint(-9, 4, shape, generator=gen,
                                          device=dev).to(dtype)
            x0 = torch.randn(shape, generator=gen, device=dev,
                             dtype=dtype) * scale
            del scale
            ref = sk.stream_copy_ref(x0.clone())
            got = sk.stream_copy_(x0.clone())
            out = sk.stream_copy_(x0, out=torch.empty_like(x0))
            torch.cuda.synchronize()
            where = f"{'x'.join(map(str, shape))} {dtype}"
            check(not torch.equal(ref, x0), f"the twin did nothing, {where}")
            check(torch.equal(got, ref), f"K4 in place differs, {where}")
            check(torch.equal(out, ref), f"K4 out of place differs, {where}")
            worst = max(worst, float((got - ref).abs().max()),
                        float((out - ref).abs().max()))
            del got, out
            flat = x0.view(-1)
            first = flat[:1].clone()
            view = flat[1:]
            ref = sk.stream_copy_ref(view.clone())
            apart = sk.stream_copy_(view, out=torch.empty_like(view))
            sk.stream_copy_(view)
            torch.cuda.synchronize()
            check(torch.equal(apart, ref),
                  f"K4 out of place on a view one element in, {where}")
            check(torch.equal(view, ref),
                  f"K4 in place on a view one element in, {where}")
            check(torch.equal(flat[:1], first),
                  f"K4 wrote before the view, {where}")
            log(f"[k4] {where}: equal to the twin bit for bit, in place and "
                f"out of place, and on a view one element in "
                f"({view.numel()} elements)")
            del x0, ref, apart, flat, view
    return worst


def phase_k4_timing(torch, sk, gpu):
    """ms a pass of K4, its twin and torch's own ``add_`` / ``add(out=)``,
    in place and out of place, f32, at the pivot-rate tableau and at K2's
    and K3's batched tableau (both beyond the 50 MB L2); bound: one read
    and one write an element.  Returns {shape: {name: ms}, plus the bound
    and what bounds it}."""
    dev = torch.device("cuda")
    out = {}
    for shape in [(10241, 10241), (16384, 32, 128)]:
        x = torch.randn(shape, device=dev)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * 4
        check(nbytes / 2 > 50e6, f"{shape} would be L2-resident")
        t = {}
        # In turns, library then kernel, so a drift hits both.
        t["add_"] = _time_ms(lambda: x.add_(1e-7))
        t["k4_in"] = _time_ms(lambda: sk.stream_copy_(x))
        t["add_out"] = _time_ms(lambda: torch.add(x, 1e-7, out=y))
        t["k4_out"] = _time_ms(lambda: sk.stream_copy_(x, out=y))
        t["twin_in"] = _time_ms(lambda: sk.stream_copy_ref(x))
        t["twin_out"] = _time_ms(lambda: sk.stream_copy_ref(x, out=y))
        b_ms, b_by = _bound_ms(nbytes, x.numel())
        t["bound"], t["bound_by"] = b_ms, b_by
        name = "x".join(map(str, shape))
        log(f"[k4-time] {name} f32 on {gpu}: " + ", ".join(
            f"{k} {t[k]!r} ms ({nbytes / t[k] / 1e6!r} GB/s, "
            f"{b_ms / t[k]!r} of the bound)"
            for k in ("k4_in", "k4_out", "twin_in", "twin_out", "add_",
                      "add_out"))
            + f"; bound {b_ms!r} ms ({b_by}, {nbytes} B); K4 out/in "
            f"{t['k4_out'] / t['k4_in']!r}")
        out[shape] = t
        del x, y
    return out


def phase_pivot_rate(torch, pivot_kernel, sk, gpu):
    """The pivot-rate path through its entry point: returns its detail
    and the K4 launches it made (its K1 launches are checked here)."""
    from simplex_tpu_torch.utils.pivot_bench import bench_pivot_update

    size, iters, reps = 10240, 64, 5
    pivot_kernel.LAUNCHES = sk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bench_pivot_update(size, iters, reps, with_batched=False)
    wall = time.perf_counter() - t0
    k1, k4 = pivot_kernel.LAUNCHES, sk.LAUNCHES
    d = res["detail"]
    # A warm-up chain and `reps` timed ones; K4 in place and ping-pong.
    check(k1 == iters * (reps + 1),
          f"the pivot chains launched K1 {k1}x, not {iters * (reps + 1)}")
    check(k4 == 2 * iters * (reps + 1),
          f"the K4 streams launched K4 {k4}x, not {2 * iters * (reps + 1)}")
    check(res["tableau"].shape == (size + 1, size + 1)
          and res["basis"].shape == (size,), "pivot-rate state shapes")
    check(d["device"] == torch.cuda.get_device_name(0), "detail.device")
    for key in ("per_pivot_ms", "empirical_stream_GBps",
                "xla_outofplace_GBps", "k4_stream_GBps",
                "k4_outofplace_GBps"):
        check(d[key] > 0 and np.isfinite(d[key]), f"detail.{key}={d[key]}")
    n_nonfinite = int((~torch.isfinite(res["tableau"])).sum())
    log(f"[pivot-rate] bench_pivot_update({size}, {iters}, {reps}) on "
        f"{gpu}: {res['value']!r} pivots/s, vs_baseline "
        f"{res['vs_baseline']!r}, K1 launches {k1}, K4 launches {k4}, "
        f"{n_nonfinite} non-finite entries in the final tableau, wall "
        f"{wall!r} s")
    log("[pivot-rate] detail " + json.dumps(d))
    del res
    return d, k4


def _mps_report(out):
    """(engine, status, Z or None, pivots, seconds) of a printed MPS
    report."""
    import re

    z = re.search(r"Z = (\S+)", out)
    it = re.search(r"Iteraciones: (\d+)\s+tiempo: (\S+)s", out)
    return (re.search(r"motor (\w+)\)", out).group(1),
            int(re.search(r"Estado: (-?\d+)", out).group(1)),
            float(z.group(1)) if z else None, int(it.group(1)),
            float(it.group(2)))


def phase_mps(torch, cli, pivot_kernel, tmpdir, gpu):
    """Phase 14 (a): the adversarial netlib-scale MPS files through the
    CLI's MPS branch, every engine, every verdict against HiGHS."""
    import contextlib
    import io

    from simplex_tpu_torch.utils import mps

    pivot_kernel.LAUNCHES = 0
    for seed in range(4):
        text = mps.generate_netlib_adversarial(seed)
        path = os.path.join(tmpdir, f"adversarial{seed}.mps")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        lp = mps.parse_mps(text)
        st_ref, z_ref = _highs_bounded(lp.c, lp.A, lp.b, lp.ops,
                                       lp.maximize, lp.lb, lp.ub)
        parts = []
        for engine in ("auto", "revised", "dense", "host"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["solve", path, "--engine", engine,
                               "--device", "cuda"])
            chosen, st, z, nit, secs = _mps_report(buf.getvalue())
            check(st == st_ref, f"adversarial {seed} --engine {engine}: "
                  f"status {st}, HiGHS {st_ref}")
            check(rc == (0 if st == 0 else 1),
                  f"adversarial {seed} --engine {engine}: rc {rc}")
            if st == 0:
                check(_gate(z_ref, z), f"adversarial {seed} --engine "
                      f"{engine}: z={z!r} vs HiGHS {z_ref!r}")
            parts.append(f"{engine}->{chosen} status {st} z={z!r} "
                         f"{nit} pivots {secs!r} s")
        log(f"[mps] adversarial {seed} ({lp.n_cons}x{lp.n_vars}, "
            f"{int(np.sum(np.isfinite(lp.ub)))} finite ub, "
            f"{int(np.sum(lp.free))} free) on {gpu}: HiGHS status {st_ref} "
            f"z={z_ref!r}; " + "; ".join(parts))
    check(pivot_kernel.LAUNCHES >= 1,
          "the MPS branch's dense engine launched K1 no time")
    log(f"[mps] K1 launches over the four --engine dense runs: "
        f"{pivot_kernel.LAUNCHES}")


# Phase 14 (b): the revised engine's LP, at the 1:3 shape of
# tests/test_engines.py::test_revised_large_netlib_shape.  Netlib's
# large-instance scale, 2000 x 6000, was halved twice: there, and at
# 1000 x 3000, the float32 device loop stops without a certified optimum
# and the solve escalates to the host's float64 engine (on an NVIDIA H100
# 80GB HBM3, 700.00 W: 2000 x 6000 after about 3,600 iterations, 1000 x 3000
# after about 13,700); at 500 x 1500 it reaches the optimum on the card.
REVISED_M, REVISED_N = 500, 1500


class _Stop(Exception):
    """Ends a solve once its profiled window is over."""


def _profile_revised(torch, solve, chunks=6):
    """One more ``solve()``, its first ``chunks`` chunks under
    ``torch.profiler`` (the whole solve's ~700k ops would take the profiler
    many minutes to process; a chunk repeats one refactor and 64 steps),
    and the solve stopped there.  Returns the window's wall seconds, its
    pivots (one a step, an upper bound), the device time of every kernel
    and copy, and the device time launched under
    ``aten::linalg_solve_ex`` (the refactors), in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.models import revised

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    refactor, calls, window = revised._refactor, [0], {}

    def stop():
        if "wall" not in window:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()

    def counted(*args, **kw):
        # solve() refactors once, then once a chunk: stop before the
        # (chunks + 1)-th, so the window holds `chunks` of each.
        calls[0] += 1
        if calls[0] == chunks + 1:
            stop()
            raise _Stop
        return refactor(*args, **kw)

    revised._refactor = counted
    try:
        prof.start()
        window["t0"] = time.perf_counter()
        solve()
        stop()
    except _Stop:
        pass
    finally:
        revised._refactor = refactor
    dev_us, solve_us, top = 0.0, 0.0, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA \
                and not ev.key.startswith("aten::"):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            dev_us += us
            top.append((us, ev.count, ev.key))
        elif ev.key == "aten::linalg_solve_ex":
            solve_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    top.sort(reverse=True)
    return window["wall"], 64 * chunks - 1, dev_us, solve_us, top


def phase_revised(torch, pt, gpu, m=REVISED_M, n=REVISED_N):
    """Phase 14 (b): the revised engine on the full-width netlib-style LP
    on the card, against HiGHS, with its rate, its host reads and where
    its device time goes."""
    from simplex_tpu_torch.models import revised
    from simplex_tpu_torch.utils import mps

    lp = mps.generate_netlib_style(1, m=m, n=n, density=0.03)
    t0 = time.perf_counter()
    st_ref, z_ref = _highs_bounded(lp.c, lp.A, lp.b, lp.ops, lp.maximize,
                                   lp.lb, lp.ub)
    highs_s = time.perf_counter() - t0
    check(st_ref == 0, f"HiGHS status {st_ref} on the {m}x{n} LP")
    solver = pt.RevisedSimplexSolver(pt.SolverConfig(device="cuda"))
    # cuBLAS and cuSOLVER start up on a small LP of the same generator.
    solver.solve(mps.generate_netlib_style(1, m=m // 10, n=n // 10,
                                           density=0.03))

    from simplex_tpu_torch.runtime import graphs

    revised.STATE_READS = 0
    graphs.STEPS = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(lp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads, steps_run = revised.STATE_READS, graphs.STEPS
    peak = torch.cuda.max_memory_allocated()
    check(res.status == 0, f"{m}x{n} revised status {res.status} "
          f"({res.message}, {res.nit} pivots)")
    check(not res.escalated, f"{m}x{n} revised solve escalated")
    check(res.x is not None and res.x.shape == (n,)
          and bool(np.all(np.isfinite(res.x))), "revised x not finite")
    check(_gate(z_ref, res.z), f"{m}x{n} revised z={res.z!r} vs HiGHS "
          f"{z_ref!r}")
    # One read a chunk of 64 iterations; each of the two phases adds at
    # most two partial chunks.
    check(reads <= res.nit / 64 + 4,
          f"{reads} host reads of the loop state for {res.nit} pivots")
    log(f"[revised] {m}x{n} netlib-style (density 0.03) on {gpu}: status 0, "
        f"z={res.z!r} (HiGHS {z_ref!r}, {highs_s!r} s on the host), "
        f"pivots={res.nit}, wall={wall!r} s, {res.nit / wall!r} pivots/s, "
        f"host reads of the loop state {reads} = {reads / res.nit!r} a "
        f"pivot, escalated={res.escalated}, peak device memory "
        f"{peak / 2**20!r} MiB")

    def run():
        with _Timed(revised, "_run_phase_revised", torch, keep=True) as ph:
            t = time.perf_counter()
            r = solver.solve(lp)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        B_inv, x_B, basis, at_up, it, st, obj = ph.kept[-1][2]
        return ({"B_inv": B_inv, "x_B": x_B, "basis": basis,
                 "at_upper": at_up, "iters": it, "status": st, "obj": obj,
                 "x": r.x, "nit": r.nit},
                {"solve": t, "pivots_per_s": r.nit / t})

    times, _ = _versus(torch, f"phase 14 (b), the revised {m}x{n} solve",
                       run, gpu, order="GE")
    # A phase stops after its verdict step: its iterations plus at most
    # one step a chunk.
    _loop_exit("phase 14 (b)", f"steps for {res.nit} iterations in {reads} "
               "chunks", steps_run, res.nit + reads,
               {k: v["solve"] for k, v in times.items()}, gpu)

    for kind in ("eager", "graph"):
        graphs._EAGER = kind == "eager"
        try:
            wall_p, steps, dev_us, solve_us, top = _profile_revised(
                torch, lambda: solver.solve(lp))
        finally:
            graphs._EAGER = False
        if kind == "eager" and dev_us:
            log(f"[graphs-busy] phase 14 (b) revised, the first {steps} "
                f"steps, eager on {gpu}: wall {wall_p!r} s under the "
                f"profiler, busy {dev_us / 1e6 / wall_p!r}")
    if dev_us == 0:
        log("[revised-profile] the profiler saw no device time")
        return
    per_step = (dev_us - solve_us) / 1e3 / steps
    log(f"[revised-profile] graphs, on {gpu}: the first {steps} steps and their "
        f"refactors, wall {wall_p!r} s under the profiler; device time "
        f"{dev_us / 1e3!r} ms = {dev_us / 1e6 / wall_p!r} of that wall; "
        f"linalg.solve_ex (the refactors) {solve_us / 1e3!r} ms = "
        f"{solve_us / dev_us!r} of the device time, the per-step ops the "
        f"rest ({per_step!r} ms a step); at that rate the {res.nit} pivots' "
        f"device time is {(dev_us / steps) * res.nit / 1e6!r} s = "
        f"{(dev_us / steps) * res.nit / 1e6 / wall!r} of the unprofiled "
        f"wall")
    for us, cnt, key in top[:8]:
        log(f"[revised-profile]   {us / 1e3!r} ms, {cnt} calls: {key[:90]}")


# The max anchor as the web form of /new.
ANCHOR_FORM = {
    "problem_type": "maximize",
    "objective[]": ["15", "18"],
    "constraint_1[]": ["4", "2", "20"],
    "constraint_2[]": ["2", "6", "28"],
    "constraint_sign[]": ["<=", "<=", "<="],
    "constraint_rhs[]": ["2000", "2400", "14000"],
}


def phase_web(torch, cli, pivot_kernel, profiling, gpu):
    """Phase 15: the web app on the card through its in-process client,
    then the CLI's export-pdf."""
    import contextlib
    import io

    from simplex_tpu_torch.config import SolverConfig
    from simplex_tpu_torch.utils import mps
    from simplex_tpu_torch.web.app import init_app
    from simplex_tpu_torch.web.microweb import TestClient

    check(SolverConfig.from_env().device == "cuda",
          "the web app's config does not default to the card")
    client = TestClient(init_app())
    r = client.get("/")
    check(r.status_code == 200, f"GET / {r.status_code}")
    before = json.loads(client.get("/metrics").text)["solves"]
    n_rec = len(profiling.DEFAULT_METRICS.records)

    from simplex_tpu_torch.runtime import graphs

    pivot_kernel.LAUNCHES = 0
    r = client.post("/new", data=ANCHOR_FORM)
    check(r.status_code == 200 and "Vista previa" in r.text,
          "POST /new gave no preview")
    # The first request pays for its graphs' captures.
    graphs.clear()
    captures = graphs.CAPTURES
    t0 = time.perf_counter()
    r = client.post("/solve")
    first_s = time.perf_counter() - t0
    captures = graphs.CAPTURES - captures
    launches = pivot_kernel.LAUNCHES
    check(r.status_code == 200 and "Solucion Factible" in r.text
          and "9833.3333" in r.text, "POST /solve: no Z = 9833.3333")
    check(launches >= 1, "the web /solve launched K1 no time")

    after = json.loads(client.get("/metrics").text)["solves"]
    recs = profiling.DEFAULT_METRICS.records
    check(after.get("solves", 0) == before.get("solves", 0) + 1
          and len(recs) == n_rec + 1, f"/metrics: {before} -> {after}")
    rec = recs[-1]
    check((rec.engine, rec.status, rec.n_vars, rec.n_cons)
          == ("dense", 0, 2, 3), f"/metrics record {rec.to_json()}")

    # Repeats (the session's problem is consumed by /solve, so each is
    # posted anew): through the cached graphs, eagerly, and in turns again;
    # each the same page.
    repeat = {"graph": [], "eager": []}
    for kind in ("graph", "eager", "graph", "eager"):
        check(client.post("/new", data=ANCHOR_FORM).status_code == 200,
              "POST /new before a repeated /solve")
        graphs._EAGER = kind == "eager"
        try:
            t0 = time.perf_counter()
            r2 = client.post("/solve")
            repeat[kind].append(time.perf_counter() - t0)
        finally:
            graphs._EAGER = False
        check(r2.status_code == 200 and "9833.3333" in r2.text,
              f"repeated /solve ({kind}): no Z = 9833.3333")
    log(f"[graphs] phase 15 web /solve of the max anchor on {gpu}: the "
        f"first request {first_s!r} s ({captures} captures), repeats "
        f"through the graphs {repeat['graph']!r} s, eager "
        f"{repeat['eager']!r} s")

    r = client.get("/exportar-pdf")
    check(r.status_code == 200 and r.data.startswith(b"%PDF")
          and b"9833.3333" in r.data, "GET /exportar-pdf gave no PDF")
    pdf_bytes = len(r.data)

    r = client.post("/load", files={"problem_file": (
        "adversarial0.mps", mps.generate_netlib_adversarial(0))},
        follow_redirects=True)
    free = "variables libres" in r.text
    check(r.status_code == 200 and ("Vista previa" in r.text or free),
          "POST /load of the MPS file gave neither preview nor message")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export-pdf"])
    out = buf.getvalue().strip()
    path = out.rsplit(" ", 1)[-1]
    check(rc == 0 and os.path.exists(path), f"export-pdf: {out!r}")
    with open(path, "rb") as f:
        check(f.read(5) == b"%PDF-", f"{path} is not a PDF")
    log(f"[web] on {gpu}: GET / 200; /new + /solve Z=9833.3333 with "
        f"{launches} K1 launches; /metrics {after} with the record "
        f"{rec.to_json()}; /exportar-pdf {pdf_bytes} bytes; "
        f"/load of adversarial 0 (MPS): "
        f"{'free-variable message' if free else 'preview'}; CLI "
        f"export-pdf wrote {os.path.basename(path)}")


class _Timed:
    """Replaces ``module.name`` while in use by a wrapper that records each
    call's (start, end) on the host clock, with a device sync at both ends
    when ``torch`` is given (never from a worker thread), and restores it
    on exit.  With ``keep``, each call's ``(args, kwargs, result)`` is kept
    in ``kept``."""

    def __init__(self, module, name, torch=None, keep=False):
        self.module, self.name, self.torch = module, name, torch
        self.calls, self.keep, self.kept = [], keep, []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            if self.torch is not None:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if self.keep:
                    self.kept.append((args, kw, out))
                return out
            finally:
                if self.torch is not None:
                    self.torch.cuda.synchronize()
                self.calls.append((t0, time.perf_counter()))

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def seconds(self):
        return sum(t1 - t0 for t0, t1 in self.calls)


def _numpy(x):
    """A tensor, an array or a number as a numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same_bits(a, b):
    a, b = _numpy(a), _numpy(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _versus(torch, label, run, gpu, order="GEGE"):
    """``run()`` through the solve loops' CUDA graphs (``G``) and through
    their eager chunks (``E``: the private switch of ``runtime/graphs.py``),
    in the order given, each between two device syncs.  ``run()`` returns
    ``(outputs, seconds)``: a dict of tensors, arrays and numbers that every
    run must reproduce bit for bit, and a dict of the seconds it measured.
    Returns ``({"graph": {name: [s, ...]}, "eager": {...}}, outputs)``."""
    from simplex_tpu_torch.runtime import graphs

    times = {"graph": {}, "eager": {}}
    ref = None
    for mode in order:
        kind = "eager" if mode == "E" else "graph"
        graphs._EAGER = mode == "E"
        try:
            torch.cuda.synchronize()
            out, secs = run()
            torch.cuda.synchronize()
        finally:
            graphs._EAGER = False
        for k, v in secs.items():
            times[kind].setdefault(k, []).append(v)
        if ref is None:
            ref = out
            continue
        check(sorted(out) == sorted(ref), f"{label}: outputs {sorted(out)}")
        for k in ref:
            check(_same_bits(ref[k], out[k]),
                  f"{label}: {k} of a {kind} run differs from the first "
                  f"run ({'eager' if order[0] == 'E' else 'graph'})")
    log(f"[graphs] {label} on {gpu}: runs {order} (G graphs, E eager) "
        f"bit-equal in {sorted(ref)}; seconds, graphs {times['graph']}, "
        f"eager {times['eager']}")
    return times, ref


def _busy(torch, label, fn, gpu):
    """``fn()`` under ``torch.profiler``, once through the graphs and once
    eagerly: the device busy share of each wall (under the profiler)."""
    from simplex_tpu_torch.runtime import graphs

    shares = {}
    for kind in ("graph", "eager"):
        graphs._EAGER = kind == "eager"
        try:
            wall, events = _profiled(torch, fn)
        finally:
            graphs._EAGER = False
        dev_us = sum(us for us, _, _ in events)
        shares[kind] = (wall, dev_us / 1e6 / wall)
    log(f"[graphs-busy] {label} on {gpu} under torch.profiler: graphs wall "
        f"{shares['graph'][0]!r} s, busy {shares['graph'][1]!r}; eager wall "
        f"{shares['eager'][0]!r} s, busy {shares['eager'][1]!r}")
    return shares


def _graph_stats(label):
    """Log the graph cache: each entry's loop, graphs and bytes on the
    card, the chunks run so far and the process's capture seconds."""
    from simplex_tpu_torch.runtime import graphs
    from simplex_tpu_torch.utils.profiling import span_stats

    stats = graphs.stats()
    capture_s = span_stats().get("graphs.capture", {}).get("total_s", 0.0)
    log(f"[graphs-cache] after {label}: {len(stats)} entries, "
        f"{graphs.cache_bytes()} bytes on the card; captures "
        f"{graphs.CAPTURES} in {capture_s!r} s, replays {graphs.REPLAYS}, "
        f"eager chunks {graphs.EAGER_CHUNKS}; entries {json.dumps(stats)}")


# Each loop's launches (the revised engine's steps) and seconds before its
# chunks stopped at the verdict: PERF.md sections 5-6, PR 10's chip runs
# (NVIDIA H100 80GB HBM3, 700.00 W), when every chunk ran its full length.
BEFORE_EXIT = {
    "phase 5": "1,439 K1 launches for 1,115 pivots; solve_tableau "
               "0.275-0.327 s through graphs, 1.26-2.34 s eager",
    "phase 8": "64 K2 launches for 28 iterations; the loop 0.0116-0.0135 s "
               "through graphs, 0.0243-0.0608 s eager",
    "phase 11": "64 K3 launches for 31 iterations; the loop 0.0129-0.0150 "
                "s through graphs, 0.0260-0.0527 s eager",
    "phase 14 (b)": "every chunk at its full length, up to 63 masked steps "
                    "a phase; 2,486-2,699 pivots/s through graphs, 330-450 "
                    "eager",
    "phase 16 (a)": "259 K1 launches for 148 pivots; the device loop "
                    "0.093-0.102 s through graphs, 0.290-0.553 s eager",
    "phase 16 (b)": "390 K1 launches over the shrink and the increase",
    "phase 20 (c)": "96 steps (3 chunks of 32) for 68 iterations; 2.45-3.27 "
                    "s the whole solve_arrays_sharded",
    "phase 20 (d)": "768 steps for 768 iterations; 1.21-1.262 ms a pivot "
                    "through graphs",
}


def _loop_exit(label, what, count, bound, times, gpu, exact=False):
    """A loop's launches (or steps) against the bound its exit at the
    verdict sets, with its seconds through graphs and eager and the figures
    from before the exit; the run fails past the bound (off it, where
    ``exact``)."""
    ok = count == bound if exact else count <= bound
    check(ok, f"{label}: {count} {what}, bound {bound}"
          f"{' exactly' if exact else ''}")
    log(f"[loop-exit] {label} on {gpu}: {count} {what}, bound {bound}"
        f"{' (exact)' if exact else ''}; seconds through graphs "
        f"{times['graph']}, eager {times['eager']}; before the loops "
        f"stopped at the verdict (PERF.md, PR 10): "
        f"{BEFORE_EXIT.get(label, 'no count recorded')}")


def phase_reoptimize(torch, pt, pivot_kernel, gpu, basis, size=2048):
    """Phase 16 (a): the dual reoptimizer on phase 5's LP after an RHS
    shrink, from phase 5's basis."""
    from scipy.optimize import linprog

    from simplex_tpu_torch.models import dense
    from simplex_tpu_torch.ops import tableau

    c, A, b = dense_lp(size)
    b2 = b * (1.0 - np.random.default_rng(16).uniform(0.01, 0.05, size))
    lp2 = pt.LinearProgram(c=c, A=A, b=b2, ops=np.full(size, -1),
                           maximize=True)
    # Float64: in float32 the dual loop loses dual feasibility on this LP
    # and runs to its cap, in the JAX package too (ROADMAP.md, Queue 3).
    cfg = pt.SolverConfig(device="cuda", dtype="float64")
    pivot_kernel.LAUNCHES = 0
    tableau.STATE_READS = 0
    with _Timed(tableau, "solve_tableau_dual", torch) as loop, \
            _Timed(dense, "solve_lp") as cold:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.reoptimize(lp2, basis, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    launches, reads = pivot_kernel.LAUNCHES, tableau.STATE_READS
    check(len(loop.calls) == 1 and not cold.calls,
          f"solve_tableau_dual ran {len(loop.calls)} times, the cold "
          f"solve_lp {len(cold.calls)}")
    check(res.status == 0, f"reoptimize status {res.status}")
    check(launches >= res.nit and launches >= 1,
          f"K1 launches {launches} < dual pivots {res.nit}")
    t4 = time.perf_counter()
    ref = linprog(-c, A_ub=A, b_ub=b2, method="highs")
    highs_s = time.perf_counter() - t4
    check(ref.status == 0 and _gate(-ref.fun, res.z),
          f"reoptimize z={res.z!r} vs HiGHS {-ref.fun!r}")
    t5 = time.perf_counter()
    cold_res = pt.solve_lp(lp2, cfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t5
    check(cold_res.status == 0 and _gate(-ref.fun, cold_res.z),
          "the cold solve of the shrunk LP")
    (t1, t2), = loop.calls
    log(f"[reoptimize] {size}x{size} dense LP, b shrunk by U(0.01, 0.05) "
        f"(seed 16), float64, from phase 5's basis on {gpu}: status 0, "
        f"z={res.z!r} "
        f"(HiGHS {-ref.fun!r}, {highs_s!r} s on the host), {res.nit} dual "
        f"pivots against {cold_res.nit} for a cold float64 solve_lp "
        f"({cold_s!r} s); wall {t3 - t0!r} s = before the loop (standard "
        f"form, the host f64 refactor and the dual-feasibility gate, the "
        f"upload) {t1 - t0!r} s + the device loop {t2 - t1!r} s + after "
        f"it (f64 certificate, refinement, sensitivity) {t3 - t2!r} s; K1 "
        f"launches {launches}, host reads {reads}; solve_tableau_dual ran "
        f"once, the cold solve_lp not at all")

    def run():
        pivot_kernel.LAUNCHES = 0
        with _Timed(tableau, "solve_tableau_dual", torch, keep=True) as lp_:
            r = pt.reoptimize(lp2, basis, cfg)
        T, basis_o, status, iters = lp_.kept[-1][2]
        return ({"T": T, "basis": basis_o, "status": status, "iters": iters,
                 "x": r.x, "K1": pivot_kernel.LAUNCHES},
                {"device_loop": lp_.seconds()})

    times, out = _versus(torch, "phase 16 (a), the 2048x2048 float64 "
                         "reoptimize", run, gpu, order="EGEG")
    check(out["K1"] == launches, f"K1 launches {out['K1']} in the graph and "
          f"eager runs, {launches} in the first")
    _loop_exit("phase 16 (a)", f"K1 launches for {res.nit} dual pivots in "
               f"{reads} chunks", launches, res.nit + reads,
               {k: v["device_loop"] for k, v in times.items()}, gpu)
    return launches


def bounded_reopt_lp(seed, m=384, n=256):
    """``tests/test_bounds.py:316``'s generator (A from U(0.1, 1), 60 % of
    the variables bounded) at (m, n), with its RHS shrunk by U(0.01, 0.05)
    and raised by U(0.05, 0.25) (the pattern of :355)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, size=(m, n))
    x0 = rng.uniform(0.2, 1.5, size=n)
    b = A @ x0 + rng.uniform(0.05, 0.4, size=m)
    c = rng.uniform(0.1, 1.0, size=n)
    ub = np.where(rng.random(n) < 0.6, x0 * rng.uniform(0.7, 1.6, n),
                  np.inf)
    shrink = b * (1.0 - rng.uniform(0.01, 0.05, size=m))
    grow = b * (1.0 + rng.uniform(0.05, 0.25, size=m))
    return c, A, b, ub, shrink, grow


def phase_reoptimize_bounded(torch, pt, pivot_kernel, gpu, m=384, n=256):
    """Phase 16 (b): the bounded dual loop from a revised parent's
    ``(basis, at_upper)``, after an RHS shrink and an RHS increase."""
    from simplex_tpu_torch.models import dense
    from simplex_tpu_torch.ops import tableau

    cfg = pt.SolverConfig(device="cuda")
    c, A, b, ub, shrink, grow = bounded_reopt_lp(16, m, n)
    kw = dict(c=c, A=A, ops=np.full(m, -1), maximize=True, ub=ub)
    solver = pt.RevisedSimplexSolver(cfg)
    parent = solver.solve(pt.LinearProgram(b=b, **kw))
    check(parent.status == 0 and parent.at_upper is not None,
          f"revised parent status {parent.status}")
    total = 0
    for name, b2 in (("shrink", shrink), ("increase", grow)):
        lp2 = pt.LinearProgram(b=b2, **kw)
        pivot_kernel.LAUNCHES = 0
        tableau.STATE_READS = 0
        with _Timed(tableau, "solve_tableau_dual_bounded", torch) as loop, \
                _Timed(dense, "solve_lp") as cold:
            t0 = time.perf_counter()
            res = pt.reoptimize(lp2, parent.basis, cfg,
                                at_upper=parent.at_upper)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, reads = pivot_kernel.LAUNCHES, tableau.STATE_READS
        total += launches
        check(len(loop.calls) == 1 and not cold.calls,
              f"bounded {name}: the dual loop ran {len(loop.calls)} times, "
              f"the cold fallback {len(cold.calls)}")
        check(res.status == 0 and res.at_upper is not None,
              f"bounded {name}: status {res.status}")
        st, z_ref = _highs_bounded(c, A, b2, np.full(m, -1), True,
                                   np.zeros(n), ub)
        check(st == 0 and _gate(z_ref, res.z),
              f"bounded {name}: z={res.z!r} vs HiGHS {z_ref!r}")
        cold_res = solver.solve(lp2)
        check(cold_res.status == 0 and _gate(z_ref, cold_res.z),
              f"bounded {name}: the cold revised solve")
        log(f"[reoptimize-bounded] {m}x{n}, 60 % of the variables bounded, "
            f"RHS {name} from the revised parent's basis and at_upper on "
            f"{gpu}: status 0, z={res.z!r} (HiGHS {z_ref!r}), {res.nit} "
            f"dual pivots against {cold_res.nit} for a cold revised solve "
            f"(parent: {parent.nit}), {int(res.at_upper.sum())} columns at "
            f"upper, wall {wall!r} s, the loop {loop.seconds()!r} s, K1 "
            f"launches {launches}; no cold fallback")

        def run():
            with _Timed(tableau, "solve_tableau_dual_bounded", torch,
                        keep=True) as lp_:
                r = pt.reoptimize(lp2, parent.basis, cfg,
                                  at_upper=parent.at_upper)
            T, basis_o, at_up, status, iters = lp_.kept[-1][2]
            return ({"T": T, "basis": basis_o, "at_upper": at_up,
                     "status": status, "iters": iters, "x": r.x},
                    {"device_loop": lp_.seconds()})

        times, _ = _versus(torch, f"phase 16 (b), the bounded {name} "
                           "reoptimize", run, gpu, order="EG")
        _loop_exit("phase 16 (b)", f"K1 launches for {res.nit} dual pivots "
                   f"in {reads} chunks (RHS {name})", launches,
                   res.nit + reads,
                   {k: v["device_loop"] for k, v in times.items()}, gpu)
    return total


def pdhg_cell(B, m=20, n=30):
    """The batch of ``bench.py::bench_pdhg`` (same generator and seed), in
    min form: ``c`` negated."""
    rng = np.random.default_rng(0)
    A = rng.uniform(0.05, 1.0, size=(B, m, n)).astype(np.float32)
    b = rng.uniform(1.0, 5.0, size=(B, m)).astype(np.float32)
    c = -rng.uniform(0.1, 1.0, size=(B, n)).astype(np.float32)
    return A, b, c


def _pdhg_gate(z_ref, z):
    """``tests/test_engines.py:169``'s gate: within 2e-3 relative."""
    return abs(z - z_ref) <= 2e-3 * abs(z_ref) + 1e-12


def _profile_ops(torch, fn, op):
    """``fn()`` under ``torch.profiler``: its wall seconds, the device time
    of every kernel and copy (us) and the device time launched under the
    aten op ``op`` (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = op_us = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA \
                and not ev.key.startswith("aten::"):
            dev_us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0))
        elif ev.key == op:
            op_us += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return wall, dev_us, op_us


def phase_pdhg(torch, pt, gpu, B=65536, m=20, n=30, tol=1e-4,
               max_iters=10000):
    """Phase 17: ``_pdhg_solve`` at ``bench.py::bench_pdhg``'s cell on
    staged inputs, against HiGHS on a sample; then bounded PDHG."""
    from scipy.optimize import linprog

    from simplex_tpu_torch.models import pdhg

    A, b, c = pdhg_cell(B, m, n)
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in (A, b, c)] + [
        torch.zeros((B, m), dtype=torch.bool, device=dev)]
    pdhg._pdhg_solve(*args, max_iters=81, tol=tol)         # warm-up
    times = []
    for _ in range(3):
        pdhg.STATE_READS = 0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = pdhg._pdhg_solve(*args, max_iters=max_iters, tol=tol)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 1e3)
    reads = pdhg.STATE_READS
    x, y, primal, dual, gap, done, iters = out
    x = x.cpu().numpy().astype(np.float64)
    y = y.cpu().numpy().astype(np.float64)
    done = done.cpu().numpy()
    med = statistics.median(times)
    check(reads <= iters / 40 + 2,
          f"{reads} host reads for {iters} iterations")
    check(bool(np.all(np.isfinite(x))) and x.shape == (B, n), "x not finite")
    sample = np.random.default_rng(17).choice(B, size=256, replace=False)
    checked = 0
    for i in sample:
        if not done[i]:
            continue
        A64, b64, c64 = (A[i].astype(np.float64), b[i].astype(np.float64),
                         c[i].astype(np.float64))
        ref = linprog(c64, A_ub=A64, b_ub=b64, method="highs")
        z = float(c64 @ x[i])
        check(ref.status == 0 and _pdhg_gate(ref.fun, z),
              f"PDHG instance {i}: {z!r} vs HiGHS {ref.fun!r}")
        scale = 1.0 + max(np.abs(b64).max(), np.abs(c64).max())
        pr = np.maximum(A64 @ x[i] - b64, 0.0).max()
        du = np.maximum(-(c64 + A64.T @ y[i]), 0.0).max()
        gp = abs(c64 @ x[i] + b64 @ y[i])
        check(pr <= tol * scale and du <= tol * scale
              and gp <= 10 * tol * scale,
              f"PDHG instance {i}: f64 residuals {pr!r} {du!r} {gp!r} over "
              f"tol*scale {tol * scale!r}")
        checked += 1
    check(checked >= 200, f"only {checked} of 256 sampled converged")
    log(f"[pdhg] {B} x ({m}x{n}) f32, bench_pdhg's cell, on {gpu}: device "
        f"solve {med!r} s (median of 3 on CUDA events, all "
        f"{[round(t, 4) for t in times]}) = {B / med!r} LPs/s; {iters} "
        f"iterations, converged {float(done.mean())!r} "
        f"({int(done.sum())}), host reads {reads} (limit "
        f"{iters / 40 + 2!r}); {checked} converged of 256 sampled within "
        f"2e-3 of HiGHS and their f64 residuals within tol*scale")
    from simplex_tpu_torch.runtime import graphs

    graphs._EAGER = True
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        eager_out = pdhg._pdhg_solve(*args, max_iters=max_iters, tol=tol)
        e1.record()
        torch.cuda.synchronize()
        eager_s = e0.elapsed_time(e1) / 1e3
    finally:
        graphs._EAGER = False
    # Graph against eager: iterations and verdicts equal; x, y and the
    # residuals bit for bit (cuBLAS's batched matvecs included).
    check(eager_out[6] == iters, f"PDHG iterations: eager {eager_out[6]}, "
          f"graphs {iters}")
    check(_same_bits(eager_out[5], out[5]), "PDHG converged flags differ "
          "between graphs and eager")
    diff = [int((_numpy(g) != _numpy(e)).sum())
            for g, e in zip(out[:5], eager_out[:5])]
    check(not any(diff), f"PDHG x, y, primal, dual, gap: {diff} entries "
          f"differ between graphs and eager")
    log(f"[graphs] phase 17 PDHG {B} x ({m}x{n}) device solve on {gpu}: "
        f"graphs {times!r} s, eager {eager_s!r} s (CUDA events); iterations, "
        f"converged flags, x, y and residuals bit-equal")
    for kind in ("eager", "graph"):
        graphs._EAGER = kind == "eager"
        try:
            wall, dev_us, mv_us = _profile_ops(
                torch, lambda: pdhg._pdhg_solve(*args, max_iters=401,
                                                tol=tol), "aten::bmm")
        finally:
            graphs._EAGER = False
        if kind == "eager":
            log(f"[graphs-busy] phase 17 PDHG, the first 401 iterations, "
                f"eager on {gpu}: wall {wall!r} s under the profiler, busy "
                f"{dev_us / 1e6 / max(wall, 1e-9)!r}")
    if dev_us:
        log(f"[pdhg-profile] the first 401 iterations under torch.profiler "
            f"through the graphs on {gpu}: wall {wall!r} s, device time {dev_us / 1e3!r} ms = "
            f"{dev_us / 1e6 / wall!r} of the wall; the matvecs (aten::bmm) "
            f"{mv_us / 1e3!r} ms = {mv_us / dev_us!r} of the device time, "
            f"elementwise and reductions the rest; "
            f"{(wall - dev_us / 1e6) / 401 * 1e3!r} ms a iteration off the "
            f"device")
    else:
        log("[pdhg-profile] the profiler saw no device time")

    Bb = min(4096, B)
    rng = np.random.default_rng(18)
    ub = np.where(rng.random((Bb, n)) < 0.6, rng.uniform(1.0, 3.0, (Bb, n)),
                  np.inf)
    t0 = time.perf_counter()
    res = pt.PdhgSolver(tol=tol, max_iters=max_iters, device="cuda") \
        .solve_arrays(-c[:Bb], A[:Bb], b[:Bb], np.full(m, -1),
                      maximize=True, ub=ub)
    wall_b = time.perf_counter() - t0
    check(bool(np.all(res.x <= ub + 1e-4)), "bounded PDHG x above ub")
    checked = 0
    for i in np.random.default_rng(19).choice(Bb, size=min(512, Bb),
                                              replace=False):
        if not res.converged[i]:
            continue
        st, z_ref = _highs_bounded(-c[i].astype(np.float64),
                                   A[i].astype(np.float64),
                                   b[i].astype(np.float64), np.full(m, -1),
                                   True, np.zeros(n), ub[i])
        check(st == 0 and _pdhg_gate(z_ref, res.objective[i]),
              f"bounded PDHG instance {i}: {res.objective[i]!r} vs HiGHS "
              f"{z_ref!r}")
        checked += 1
    check(checked >= 0.75 * min(512, Bb),
          f"only {checked} of the bounded sample converged")
    log(f"[pdhg-bounded] {Bb} x ({m}x{n}) with 60 % of the variables "
        f"bounded by U(1, 3), PdhgSolver.solve_arrays(ub=) on {gpu}: "
        f"{res.iters} iterations, converged {float(res.converged.mean())!r}, "
        f"wall {wall_b!r} s; {checked} converged of 512 sampled within 2e-3 "
        f"of HiGHS")


def stream_chunks(n_chunks, chunk, m, n, seed0):
    """``bench.py::bench_stream``'s (seed0 100, 20x30) and
    ``bench_stream_exact``'s (seed0 300, 30x50) chunk generator."""
    for k in range(n_chunks):
        rng = np.random.default_rng(seed0 + k)
        A = rng.uniform(0.05, 1.0, size=(chunk, m, n)).astype(np.float32)
        b = rng.uniform(1.0, 5.0, size=(chunk, m)).astype(np.float32)
        c = rng.uniform(0.1, 1.0, size=(chunk, n)).astype(np.float32)
        yield c, A, b, np.full((m,), -1)


def phase_pdhg_stream(torch, pt, bk, pivot_kernel, gpu, chunk=250_000,
                      n_chunks=2, m=20, n=30):
    """Phase 18: the PDHG stream with crossover at ``bench_stream``'s chunk
    width; then the per-instance crossover path."""
    from scipy.optimize import linprog

    from simplex_tpu_torch.models import pdhg

    kept = []

    def gen():
        for batch in stream_chunks(n_chunks, chunk, m, n, 100):
            kept.append(batch)
            yield batch

    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    t0 = time.perf_counter()
    outs = []
    for res in pdhg.solve_arrays_stream(
            gen(), tol=1e-4, max_iters=10000, maximize=True,
            crossover="unconverged", device="cuda"):
        outs.append(res)
    wall = time.perf_counter() - t0
    k2 = bk.LAUNCHES
    converged = recovered = checked = 0
    for k, (res, (c, A, b, _)) in enumerate(zip(outs, kept)):
        check(bool(np.all(res.converged)),
              f"chunk {k}: {int(np.sum(~res.converged))} instances neither "
              f"converged nor recovered")
        n_rec = len(res.exact or {})
        recovered += n_rec
        converged += chunk - n_rec
        for i in list(res.exact or {})[:32]:
            r = res.exact[i]
            ref = linprog(-c[i].astype(np.float64),
                          A_ub=A[i].astype(np.float64),
                          b_ub=b[i].astype(np.float64), method="highs")
            check(r.success and _gate(-ref.fun, r.z)
                  and _gate(-ref.fun, res.objective[i]),
                  f"chunk {k} instance {i}: recovered z={r.z!r} vs HiGHS "
                  f"{-ref.fun!r}")
            checked += 1
    A, b, c = (torch.as_tensor(a, device="cuda")
               for a in (kept[0][1], kept[0][2], -kept[0][0]))
    is_eq = torch.zeros((chunk, m), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = pdhg._pdhg_solve(A, b, c, is_eq, max_iters=10000, tol=1e-4)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t1
    del A, b, c, is_eq, out
    log(f"[pdhg-stream] {n_chunks} chunks of {chunk} x ({m}x{n}) (half of "
        f"bench_stream's 1M cell, at its full chunk width), seeds 100+k, "
        f"crossover='unconverged', on {gpu}: wall {wall!r} s = "
        f"{n_chunks * chunk / wall!r} LPs/s end to end; {converged} "
        f"converged, {recovered} recovered by the batched crossover "
        f"({k2} K2 launches), every instance one or the other; {checked} "
        f"recovered vertices within 1e-6 (1+|z|) of HiGHS; chunk walls "
        f"{[round(r.solve_time, 3) for r in outs]} s; the device solve "
        f"re-timed on a staged chunk {dev_s!r} s, x {n_chunks} = "
        f"{dev_s * n_chunks!r} s, wall / that {wall / (dev_s * n_chunks)!r}")

    B = 32
    c, A, b = (a[:B] for a in kept[0][:3])
    pivot_kernel.LAUNCHES = 0
    t2 = time.perf_counter()
    res = next(pdhg.solve_arrays_stream(
        iter([(c, A, b, np.full(m, -1))]), tol=1e-4, max_iters=10000,
        maximize=True, crossover="all", device="cuda"))
    wall_x = time.perf_counter() - t2
    check(len(res.exact) == B and all(r.success for r in res.exact.values()),
          "crossover='all' on 32 instances: not every vertex recovered")
    for i, r in res.exact.items():
        ref = linprog(-c[i].astype(np.float64), A_ub=A[i].astype(np.float64),
                      b_ub=b[i].astype(np.float64), method="highs")
        check(_gate(-ref.fun, r.z), f"crossover_batch instance {i}: "
              f"z={r.z!r} vs HiGHS {-ref.fun!r}")
    nits = [r.nit for r in res.exact.values()]
    log(f"[crossover] {B} instances, crossover='all' (crossover_batch, one "
        f"reoptimize an instance) on {gpu}: all recovered, z within "
        f"1e-6 (1+|z|) of HiGHS, dual pivots mean {float(np.mean(nits))!r} "
        f"max {max(nits)}, K1 launches {pivot_kernel.LAUNCHES}, wall "
        f"{wall_x!r} s")
    return k2


def _chrome_overlap(path, kernel_key):
    """From a ``torch.profiler`` chrome trace: the host-to-device copies
    on another stream than the kernels whose name holds ``kernel_key``,
    and how many of them overlap one of those kernels in time."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
               for e in events if e.get("cat") == "kernel"
               and kernel_key in e.get("name", "")]
    streams = {s for _, _, s in kernels}
    copies = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
              for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    side = [cp for cp in copies if cp[2] not in streams]
    overlapping = [cp for cp in side
                   if any(k0 < cp[1] and cp[0] < k1 for k0, k1, _ in kernels)]
    return len(kernels), len(side), len(overlapping)


def _host_certified(pt, cfg, c, A, b, ops, maximize, ub=None):
    """``solve_arrays`` certified as the stream certifies, on the host: its
    assembly and loop (the float64 finish of a bounded batch included),
    then the host copy ``certify_uniform_result`` and the reset of an
    escalated instance's ``at_upper`` (``solve_arrays`` certifies all-<=
    batches with ``b >= 0`` on the card)."""
    from simplex_tpu_torch.models import batched as tmb

    tensors, maxi, with_art = tmb._upload(c, A, b, ops, maximize,
                                          np.dtype(cfg.dtype), cfg.device)
    res = tmb._run_batch(tmb._assemble_on_device(tensors, maxi, with_art,
                                                 ub=ub), cfg)
    return tmb._reset_at_upper(tmb.certify_uniform_result(
        res, c, A, b, ops, maximize, ub=ub), ub)


def _kkt_close(a, b):
    """Equal NaN patterns, and within 1e-12 (1 + |a|) elsewhere: two float64
    KKT solves of one basis, the card's from one LU of it, the host's from
    two."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    return bool(np.all(np.abs(a - b) <= 1e-12 * (1.0 + np.abs(a))))


def phase_batched_stream(torch, pt, bk, gpu, tmpdir, chunk=65536,
                         n_chunks=4, m=30, n=50, Bm=16384):
    """Phase 19: ``models/batched.solve_arrays_stream`` at
    ``bench_stream_exact``'s chunk, certified; its overlaps; then a mixed
    classic / bounded stream."""
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.models import batched as tmb

    from simplex_tpu_torch.runtime import staging

    cfg = pt.SolverConfig(device="cuda")
    for _ in pt.solve_arrays_stream(stream_chunks(1, 1024, m, n, 300), cfg):
        pass                                              # warm-up
    gen_s = [0.0]

    def timed_chunks():
        chunks = stream_chunks(n_chunks, chunk, m, n, 300)
        while True:
            t = time.perf_counter()
            batch = next(chunks, None)
            gen_s[0] += time.perf_counter() - t
            if batch is None:
                return
            yield batch

    bk.LAUNCHES = 0
    with _Timed(tmb, "_run_batch", torch) as runs, \
            _Timed(tmb, "certify_uniform_result") as certs, \
            _Timed(staging, "stage") as stages, \
            _Timed(staging.Staged, "upload") as uploads:
        t0 = time.perf_counter()
        outs = list(pt.solve_arrays_stream(timed_chunks(), cfg))
        wall = time.perf_counter() - t0
    for k, res in enumerate(outs):
        check(bool(np.all(res.status == 0)) and bool(np.all(res.certified)),
              f"stream chunk {k}: not all optimal and certified")
    overlaps = [certs.calls[k][0] < runs.calls[k + 1][1]
                and runs.calls[k + 1][0] < certs.calls[k][1]
                for k in range(n_chunks - 1)]
    check(all(overlaps), f"certify k / solve k+1 overlaps: {overlaps}")
    solve_s = sum(r.solve_time for r in outs)
    cert_s = certs.seconds()
    # The uploads of batches 1.. are issued inside _run_batch (after its
    # first chunk), so runs already hold them.
    serial = gen_s[0] + stages.seconds() + uploads.calls[0][1] \
        - uploads.calls[0][0] + runs.seconds() + cert_s
    c, A, b, ops = next(stream_chunks(1, chunk, m, n, 300))
    ref = _host_certified(pt, cfg, c, A, b, ops, True)
    for f in ("status", "pivots", "z", "x", "certified"):
        check(np.array_equal(getattr(ref, f), getattr(outs[0], f)),
              f"stream chunk 0: {f} differs from solve_arrays")
    card = pt.BatchedSimplexSolver(cfg).solve_arrays(c, A, b, ops,
                                                     maximize=True)
    for f in ("status", "pivots", "certified"):
        check(np.array_equal(getattr(card, f), getattr(outs[0], f)),
              f"stream chunk 0: {f} differs from solve_arrays on the card")
    for f in ("z", "x"):
        check(_kkt_close(getattr(card, f), getattr(outs[0], f)),
              f"stream chunk 0: {f} beyond 1e-12 of solve_arrays certified "
              f"on the card")
    log(f"[stream-exact] {n_chunks} chunks of {chunk} x ({m}x{n}), seeds "
        f"300+k, certified, on {gpu}: all optimal and certified, "
        f"escalated {sum(r.n_escalated for r in outs)}; wall {wall!r} s = "
        f"{n_chunks * chunk / wall!r} LPs/s (generation included); "
        f"sum of device solves {solve_s!r} s, sum of certify {cert_s!r} s, "
        f"of generation {gen_s[0]!r} s, of staging (pinned buffers and "
        f"device tensors allocated) {stages.seconds()!r} s, of the uploads "
        f"issued (pinned copy, copies enqueued; batch k+1's inside batch "
        f"k's _run_batch, after its first chunk) {uploads.seconds()!r} s; "
        f"wall / the serial sum of the four "
        f"(the solves as _run_batch with syncs, {runs.seconds()!r} s) "
        f"{wall / serial!r}; certify "
        f"of chunk k overlapped the solve of chunk k+1 on the host clock "
        f"for every k; K2 launches {bk.LAUNCHES}; chunk 0 equals "
        f"solve_arrays certified on the host in status, pivots, x and z "
        f"bit for bit, and solve_arrays certified on the card in status, "
        f"pivots and certified, x and z within 1e-12 (1 + |z|)")

    path = os.path.join(tmpdir, "stream_trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in pt.solve_arrays_stream(
                stream_chunks(2, chunk, m, n, 300), cfg):
            pass
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    n_k2, n_side, n_over = _chrome_overlap(path, "fused_pivot_step_kernel")
    check(n_over >= 1, f"no upload on the side stream overlapped a K2 "
          f"launch ({n_side} side-stream uploads, {n_k2} K2 launches)")
    log(f"[stream-exact-profile] two chunks under torch.profiler on {gpu}: "
        f"{n_side} host-to-device copies on the side stream, {n_over} of "
        f"them overlapping one of the {n_k2} K2 launches")

    classic, bounded = bench_batch(Bm), bench_bounded_batch(Bm)
    mixed = [classic, bounded, classic, bounded]
    bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    t1 = time.perf_counter()
    outs = list(pt.solve_arrays_stream(iter(mixed), cfg))
    wall_m = time.perf_counter() - t1
    k2, k3 = bk.LAUNCHES, bk.LAUNCHES_K3
    check(k2 > 0 and k3 > 0, f"mixed stream: K2 {k2}, K3 {k3} launches")
    refs = [_host_certified(pt, cfg, *bt[:4], True,
                            ub=bt[4] if len(bt) > 4 else None)
            for bt in (classic, bounded)]
    for k, res in enumerate(outs):
        ref = refs[k % 2]
        for f in ("status", "pivots", "z", "x", "certified"):
            check(np.array_equal(getattr(ref, f), getattr(res, f)),
                  f"mixed stream batch {k}: {f} differs from solve_arrays")
        check((res.at_upper is not None) == (k % 2 == 1),
              f"mixed stream batch {k}: at_upper")
    log(f"[stream-mixed] 4 x {Bm} x (30x50): phase 8's batch and phase "
        f"11's bounded batch in turns, on {gpu}: each equal bit for bit "
        f"to solve_arrays certified on the host on its batch; wall {wall_m!r} s; K2 launches {k2}, "
        f"K3 launches {k3}")
    return k2, k3



# Phase 20: the row-sharded path (parallel/sharded.py) through a one-rank
# NCCL group.  BASELINE config 5 is one LP of 100,000 rows; its float32 row
# block (40 GB) and the drift anchor beside it (40 GB more) exceed one
# card's 80 GB, so its generator runs cut to SHARDED_ROWS rows, the size the
# JAX package's record also ran on an 8-way mesh.
SHARDED_ROWS = 32768


def _lps():
    """The runner of solves across cards, whose generators make phase 20's
    LPs and the mixed batches of phases 8 and 11 (imported when first
    used: the package reads ``SIMPLEX_TPU_OUTPUT_DIR`` as it loads)."""
    from simplex_tpu_torch.utils import sharded_cards

    return sharded_cards


def config5_lp(m=SHARDED_ROWS, n=20, seed=42):
    """BASELINE config 5's generator (``tests/test_sharded.py:305-312``),
    cut to ``SHARDED_ROWS`` rows."""
    return _lps().config5_lp(m, n, seed)


def many_pivot_lp():
    """``tests/test_sharded.py:173``'s 8192 x 192 LP (seed 71)."""
    return _lps().many_pivot_lp()


def mechanism_lp():
    """``tests/test_sharded.py:147``'s 16384 x 8 LP (seed 33)."""
    return _lps().mechanism_lp()


def bound_flip_lp():
    """``tests/test_sharded.py:248``'s 2 x 256 x 12 bounded LPs (seed 13)."""
    return _lps().bound_flip_lp()


def mixed_batch(B):
    """Mixed-row 30x50 LPs (seed 11): the runner's ``mixed_batch``."""
    return _lps().mixed_batch(B)


def mixed_bounded_batch(B):
    """Mixed-row bounded 30x50 LPs (seed 77): the runner's
    ``mixed_bounded_batch``."""
    return _lps().mixed_bounded_batch(B)


def _sharded_tableau(psh, c, A, b, ops, maximize, ub=None, **kw):
    """``solve_tableau_sharded`` on the 1x1 mesh of the moment (the
    identity without a process group, NCCL with one), float32 on the
    card; ``kw`` goes to it."""
    _, arrays, bounded = psh.compile_sharded(c, A, b, ops, maximize, ub=ub)
    mesh = psh.make_mesh()
    return psh.solve_tableau_sharded(*psh.stage_shards(arrays, mesh, "cuda"),
                                     mesh=mesh, bounded=bounded, **kw)


def _collectives(torch, fn):
    """``fn()`` under ``torch.profiler`` (host and device): its wall, the
    device events (us, count, name) as :func:`_profiled` gives them, and
    the host's collective calls by name (the process group's records,
    ``nccl:*`` under NCCL) as (count, host ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], {}
    prefix = torch.distributed.get_backend() + ":"
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0 and not ev.key.startswith("aten::"):
                device.append((us, ev.count, ev.key))
        elif ev.key.startswith(prefix):
            host[ev.key] = (ev.count, ev.cpu_time_total / 1e3)
    return wall, device, host


def _spans(torch, fn, names):
    """``fn()`` under a host-only ``torch.profiler``: its result, its wall
    seconds (the profiler recording) and the host seconds of each
    ``record_function`` span in ``names``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    secs = {ev.key: ev.cpu_time_total / 1e6 for ev in prof.key_averages()
            if ev.key in names}
    return out, wall, secs


def _sharded_versus(torch, psh, graphs, label, lp, gpu):
    """``solve_tableau_sharded`` on ``lp`` through the graphs and eagerly,
    bit for bit (``_versus``), with the steps each run took."""
    def run():
        steps, t0 = graphs.STEPS, time.perf_counter()
        out = _sharded_tableau(psh, *lp)
        torch.cuda.synchronize()
        return dict(zip(("T", "basis", "obj", "status", "iters", "at_upper"),
                        out)), {"steps": graphs.STEPS - steps,
                                "s": time.perf_counter() - t0}

    times, out = _versus(torch, label, run, gpu, order="GE")
    check(times["graph"]["steps"] == times["eager"]["steps"]
          == [out["iters"]], f"{label}: steps {times} for {out['iters']} "
          "iterations")
    return times


def phase_sharded(torch, pt, pivot_kernel, bk, sk, gpu, tmpdir):
    """Phase 20: ``parallel/sharded.py`` on the card, through a one-rank
    NCCL group that ``parallel.distributed.initialize`` builds.  Returns
    K1's launches in ``bench_sharded``'s comparison."""
    from simplex_tpu_torch.parallel import distributed as pdist
    from simplex_tpu_torch.parallel import sharded as psh
    from simplex_tpu_torch.utils.sharded_bench import (bench_sharded,
                                                        sharded_problem)

    from simplex_tpu_torch.runtime import graphs

    dist = torch.distributed
    check(not dist.is_initialized(), "a process group exists before phase 20")
    t = [time.perf_counter()]
    c, A, b, ops, maxi = mixed_batch(256)
    cu, Au, bu, opsu, ubu = mixed_bounded_batch(256)
    small = {"mixed": (c, A, b, ops, maxi), "bounded":
             (cu, Au, bu, opsu, False, ubu)}
    ident = {k: _sharded_tableau(psh, *v) for k, v in small.items()}
    # (b)'s reference for the tall bounded LPs (K3, before the counts of
    # the sharded path start).
    flip = bound_flip_lp()
    flip_ref = pt.BatchedSimplexSolver(pt.SolverConfig(device="cuda")) \
        .solve_arrays(*flip[:4], maximize=True, ub=flip[4])
    t_group = time.perf_counter()
    check(pdist.initialize(f"file://{tmpdir}/nccl_store", 1, 0) is False
          and dist.is_initialized() and dist.get_backend() == "nccl",
          "initialize did not build a one-rank NCCL group")
    probe = torch.ones(1, device="cuda")
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    log(f"[sharded] on {gpu}: the solves without a group and the batched "
        f"reference {t_group - t[0]!r} s; the one-rank NCCL group and its "
        f"first all-reduce {time.perf_counter() - t_group!r} s")
    try:
        pivot_kernel.LAUNCHES = bk.LAUNCHES = bk.LAUNCHES_K3 = 0
        sk.LAUNCHES = 0
        # (a) NCCL against the identity, bit for bit; then one chunk of the
        # mixed batch under the profiler.
        for k, v in small.items():
            ref = ident[k]
            out = _sharded_tableau(psh, *v)
            for i, f in ((3, "status"), (1, "basis"), (5, "at_upper")):
                check(torch.equal(ref[i], out[i]),
                      f"{k}: {f} of the NCCL solve differs from the identity")
            check(ref[4] == out[4], f"{k}: iterations {ref[4]} / {out[4]}")
            check(torch.equal(ref[2][:, -1], out[2][:, -1]),
                  f"{k}: z of the NCCL solve differs from the identity")
            log(f"[sharded-nccl] {k} 256 x (30x50) on {gpu}: status, basis, "
                f"at_upper, iterations ({out[4]}) and z bit-equal to the 1x1 "
                f"identity mesh; statuses {np.bincount(out[3].cpu().numpy())}")
            # Through NCCL: the replayed graphs (their all-reduces and
            # all-gathers captured) against the eager chunks.
            _versus(torch, f"phase 20 (a), the {k} 256 x (30x50) batch "
                    f"through NCCL", lambda v=v: (dict(zip(
                        ("T", "basis", "obj", "status", "iters", "at_upper"),
                        _sharded_tableau(psh, *v))), {}), gpu, order="EG")
        # The NCCL calls a pivot, counted on the host: the eager chunk
        # (a replayed graph makes no host call).
        graphs._EAGER = True
        steps = graphs.STEPS
        try:
            wall, device, host = _collectives(
                torch, lambda: _sharded_tableau(psh, *small["mixed"],
                                                max_iters=psh._CHUNK))
        finally:
            graphs._EAGER = False
        steps = graphs.STEPS - steps
        nccl_dev = [(us, n, name) for us, n, name in device
                    if "nccl" in name.lower()]
        calls = sum(n for n, _ in host.values())
        log(f"[sharded-nccl] one chunk ({steps} steps) of the mixed batch "
            f"under torch.profiler on {gpu}: wall {wall!r} s, device time "
            f"{sum(us for us, _, _ in device) / 1e3!r} ms; NCCL calls on the "
            f"host (count, host ms) {host}; device events named nccl "
            f"(us, count, name): {nccl_dev}")
        check(calls >= 4 * steps, f"{calls} NCCL calls for {steps} steps")
        # One rank: NCCL runs an all-reduce in place as a no-op and an
        # all-gather as one device copy, which the trace shows as the
        # collective's range on the device's timeline.
        check(nccl_dev, f"no NCCL work on the device's timeline (device "
              f"events: {sorted(device, reverse=True)[:8]})")

        # (b) certified solves against HiGHS.
        t.append(time.perf_counter())
        c, A, b, ops = many_pivot_lp()
        t0 = time.perf_counter()
        res = psh.solve_arrays_sharded(c, A, b, ops, maximize=True,
                                       max_iters=2048)
        wall = time.perf_counter() - t0
        st, z = _highs(c[0], A[0], b[0], ops, True)
        check(res["status"][0] == 0 == st and res["certified"][0]
              and _gate(z, res["z"][0]) and res["iters"] >= 150,
              f"many-pivot LP: status {res['status'][0]} (HiGHS {st}), "
              f"certified {res['certified'][0]}, z {res['z'][0]!r} vs "
              f"{z!r}, iterations {res['iters']}")
        log(f"[sharded] 1 x 8192 x 192 (seed 71) on {gpu}: status 0, "
            f"certified, z {res['z'][0]!r} (HiGHS {z!r}), {res['iters']} "
            f"iterations, wall {wall!r} s")
        c, A, b, ops, ub = flip
        res = psh.solve_arrays_sharded(c, A, b, ops, maximize=True, ub=ub)
        check(np.array_equal(res["status"], flip_ref.status)
              and bool(np.all(res["certified"])),
              f"tall bounded: {res['status']} vs {flip_ref.status}")
        for i in range(len(c)):
            st, z = _highs_bounded(c[i], A[i], b[i], ops, True,
                                   np.zeros(len(c[i])), ub[i])
            check(st == res["status"][i] and _gate(z, res["z"][i]),
                  f"tall bounded {i}: {res['z'][i]!r} vs HiGHS {z!r}")
        log(f"[sharded] 2 x 256 x 12 bounded (seed 13) on {gpu}: statuses "
            f"{res['status']} equal to BatchedSimplexSolver's and HiGHS's, "
            f"certified, z {res['z']} within 1e-6 (1+|z|) of HiGHS, "
            f"{res['iters']} iterations")
        c, A, b, ops = mechanism_lp()
        res = psh.solve_arrays_sharded(c, A, b, ops, maximize=True,
                                       max_iters=64)
        st, z = _highs(c[0], A[0], b[0], ops, True)
        check(res["status"][0] == 0 == st and res["certified"][0]
              and not res["escalated"][0] and _gate(z, res["z"][0]),
              f"16384-row LP: status {res['status'][0]}, certified "
              f"{res['certified'][0]}, escalated {res['escalated'][0]}, "
              f"z {res['z'][0]!r} vs HiGHS {z!r}")
        log(f"[sharded] 1 x 16384 x 8 (seed 33) on {gpu}: status 0, "
            f"certified, not escalated, z {res['z'][0]!r} (HiGHS {z!r}), "
            f"{res['iters']} iterations")

        # (c) BASELINE config 5's generator cut to SHARDED_ROWS rows.
        t.append(time.perf_counter())
        c, A, b, ops = config5_lp()
        names = ("sharded.assemble", "sharded.stage", "sharded.solve",
                 "sharded.extract", "sharded.certify")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cached = graphs.cache_bytes() / 2 ** 30
        steps, chunks = graphs.STEPS, graphs.REPLAYS + graphs.EAGER_CHUNKS
        res, wall, secs = _spans(torch, lambda: psh.solve_arrays_sharded(
            c, A, b, ops, maximize=True, max_iters=512), names)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = graphs.STEPS - steps
        chunks = graphs.REPLAYS + graphs.EAGER_CHUNKS - chunks
        st, z = _highs(c[0], A[0], b[0], ops, True)
        check(res["status"][0] == 0 == st and res["certified"][0]
              and _gate(z, res["z"][0]),
              f"config 5 cut: status {res['status'][0]}, certified "
              f"{res['certified'][0]}, z {res['z'][0]!r} vs HiGHS {z!r}")
        log(f"[sharded-config5] 1 x {A.shape[1]} x 20 (BASELINE config 5's "
            f"generator, seed 42, cut from 100,000 rows: their float32 row "
            f"block and its drift anchor take 80 GB, more than one card "
            f"holds) on {gpu}: status 0, certified, escalated "
            f"{res['escalated'][0]}, z {res['z'][0]!r} (HiGHS {z!r}), "
            f"{res['iters']} iterations; wall {wall!r} s (host profiler on) "
            f"= " + ", ".join(f"{k.split('.')[1]} {secs.get(k)!r} s"
                              for k in names)
            + f"; peak device memory {peak!r} GiB, of which the graph "
            f"cache held {cached!r} GiB from the earlier solves (this "
            f"solve's own entry is private: its buffers are its tensors)")
        # A captured chunk's warm-up counts as an eager chunk too.
        _loop_exit("phase 20 (c)", f"steps in {chunks} chunks (captures' "
                   f"warm-ups included) for {res['iters']} iterations, "
                   f"K1-K4 launches {sk.LAUNCHES + pivot_kernel.LAUNCHES}",
                   steps, res["iters"], _sharded_versus(
                       torch, psh, graphs, "phase 20 (c), the config-5 cut",
                       (c, A, b, ops, True), gpu), gpu, exact=True)
        check(pivot_kernel.LAUNCHES == bk.LAUNCHES == bk.LAUNCHES_K3
              == sk.LAUNCHES == 0, "the sharded solves launched a kernel of "
              "the port (they run no kernel of their own)")

        # (d) bench_sharded, then one chunk under the profiler.
        t.append(time.perf_counter())
        pivot_kernel.LAUNCHES = 0
        steps = graphs.STEPS
        rec = bench_sharded(10240, 64, 3, compare_size=8192)
        steps = graphs.STEPS - steps
        k1 = pivot_kernel.LAUNCHES
        check(k1 == 4 * 64, f"bench_sharded's comparison launched K1 {k1}x")
        d = rec["detail"]
        # Three LPs, a warm-up solve and three timed ones each, every one
        # stopped by its cap (the LP's rows stay tight): no verdict step.
        iters = 4 * (d["steady"]["iters"] + d["with_resync_every_64"]["iters"]
                     + d["sharded_cmp_iters"])
        _loop_exit("phase 20 (d)", f"steps of bench_sharded's 12 solves for "
                   f"{iters} iterations (K1 {k1} in its comparison)", steps,
                   iters, {"graph": [d["steady"]["per_pivot_ms"] * 1e-3],
                           "eager": "below"}, gpu, exact=True)
        log(f"[sharded-bench] bench_sharded(10240, 64, 3, compare_size=8192) "
            f"on {gpu}: {rec['value']!r} pivots/s, per pivot "
            f"{d['steady']['per_pivot_ms']!r} ms, effective "
            f"{d['steady']['effective_GBps']!r} GB/s; with a resync every 64 "
            f"{d['with_resync_every_64']['per_pivot_ms']!r} ms; vs_baseline "
            f"{rec['vs_baseline']!r} (K1 launches {k1})")
        log(f"[sharded-bench] detail {json.dumps(d)}")
        graphs._EAGER = True
        try:
            pivot_kernel.LAUNCHES = 0
            rec_e = bench_sharded(10240, 64, 3, compare_size=8192)
            check(pivot_kernel.LAUNCHES == 4 * 64, "bench_sharded's "
                  f"comparison launched K1 {pivot_kernel.LAUNCHES}x")
        finally:
            graphs._EAGER = False
        de = rec_e["detail"]
        log(f"[graphs] phase 20 (d) bench_sharded at 10240 on {gpu}: per "
            f"pivot through the graphs {d['steady']['per_pivot_ms']!r} ms, "
            f"eager {de['steady']['per_pivot_ms']!r} ms; with a resync "
            f"every 64: graphs {d['with_resync_every_64']['per_pivot_ms']!r} "
            f"ms, eager {de['with_resync_every_64']['per_pivot_ms']!r} ms")
        args = sharded_problem(10240, "cuda")
        mesh = psh.make_mesh()
        steps = psh._CHUNK

        def chunk():
            return psh.solve_tableau_sharded(
                *args, mesh=mesh, max_iters=steps, refactor_every=steps + 1)

        chunk()                 # its graph captured, outside the window
        wall_g, device_g, _ = _collectives(torch, chunk)
        dev_g = sum(us for us, _, _ in device_g)
        log(f"[graphs-busy] phase 20 (d) one chunk of {steps} pivots at "
            f"10240 x 20481 through the graphs on {gpu}: wall {wall_g!r} s, "
            f"device time {dev_g / 1e3!r} ms = busy {dev_g / 1e6 / wall_g!r}")
        graphs._EAGER = True
        try:
            wall, device, host = _collectives(torch, chunk)
        finally:
            graphs._EAGER = False
        dev_us = sum(us for us, _, _ in device)
        nccl_us = sum(us for us, _, name in device if "nccl" in name.lower())
        upd_us = sum(us for us, _, name in device if "addr" in name)
        calls = sum(n for n, _ in host.values())
        host_ms = sum(ms for _, ms in host.values())
        top = sorted(device, reverse=True)[:6]
        log(f"[sharded-profile] one chunk of {steps} pivots at 10240 x 20481 "
            f"eager on {gpu}: wall {wall!r} s; device time {dev_us / 1e3!r} ms = "
            f"busy {dev_us / 1e6 / wall!r} of the wall; NCCL calls {calls} "
            f"({host}: count, host ms) = {calls / steps!r} a pivot, counting "
            f"the 9 outside the loop, their host time {host_ms!r} ms = "
            f"{host_ms / 1e3 / wall!r} of the wall; NCCL's ranges on the "
            f"device {nccl_us / 1e3!r} ms = "
            f"{nccl_us / max(dev_us, 1e-9)!r} of the device time; the rank-1 "
            f"update (addr_) {upd_us / 1e3!r} ms = "
            f"{upd_us / max(dev_us, 1e-9)!r}; top device events {top}")
        del args
    finally:
        # The graphs that captured the group's collectives go first.
        torch.cuda.synchronize()
        graphs.clear()
        dist.destroy_process_group()
    t.append(time.perf_counter())
    # (e) the runner of solves across cards, as one rank on this card: its
    # collectives, its loop through graphs against eager chunks and its
    # layout against HiGHS, on (b)'s LPs and the mixed batches.
    out = subprocess.run(
        [sys.executable, "-m", "simplex_tpu_torch.utils.sharded_cards",
         "--ranks", "1", "--phases", "abc", "--timeout", "400"],
        capture_output=True, text=True, timeout=500,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in out.stdout.splitlines():
        log(f"[sharded-cards] {line}")
    check(out.returncode == 0, f"sharded_cards --ranks 1 exited with "
          f"{out.returncode}: {out.stderr[-2000:]}")
    t.append(time.perf_counter())
    log(f"[sharded] phase 20 on {gpu}: (a) {t[1] - t[0]!r} s, (b) "
        f"{t[2] - t[1]!r} s, (c) {t[3] - t[2]!r} s, (d) {t[4] - t[3]!r} s, "
        f"(e) {t[5] - t[4]!r} s (HiGHS and the generators included)")
    return k1


# Phase 21: the measurement runner, one subprocess a mode, at the shapes
# of phases 13 (with the batched sub-benches of phases 8 and 11), 8, 5,
# 17, 20, 18 and 19: (label, flags, gate).  Each gate reads the mode's JSON
# line (its ``detail["launches"]`` counts each kernel's launches).
def _gate_pivot(rec):
    d, n = rec["detail"], rec["detail"]["launches"]
    return (d["batched_n_optimal"] == d["bounded_n_optimal"] == 1024
            and n["K1"] == 64 * 6 and n["K4"] == 2 * 64 * 6
            and n["K2"] > 0 and n["K3"] > 0)


BENCH_MODES = [
    ("default mode: the pivot rate at 10241^2 and its four batched "
     "sub-benches (B=1024 and 16384, classic and bounded)", [],
     _gate_pivot),
    ("--batch --batch-size 16384", ["--batch", "--batch-size", "16384"],
     lambda r: r["vs_baseline"] == 1.0 and r["detail"]["launches"]["K2"]
     > 0),
    ("--solve-dense (2048^2)", ["--solve-dense"],
     lambda r: r["detail"]["status"] == 0 and r["vs_baseline"] == 1.0
     and r["detail"]["launches"]["K1"] >= r["detail"]["pivots"]),
    ("--pdhg --reps 3 (65,536 x (20x30))", ["--pdhg", "--reps", "3"],
     lambda r: r["vs_baseline"] >= 200 / 256),
    ("--sharded (10240, the 1x1 mesh without a group)", ["--sharded"],
     lambda r: r["value"] > 0 and r["detail"]["launches"]["K1"] == 4 * 64),
    ("--stream --stream-total 250000 (1 chunk of 250,000)",
     ["--stream", "--stream-total", "250000"],
     lambda r: r["detail"]["converged_frac"] == 1.0
     and (r["detail"]["exact_recovered"] == 0
          or r["detail"]["launches"]["K2"] > 0)),
    ("--stream-exact --stream-total 262144 (4 chunks of 65,536)",
     ["--stream-exact", "--stream-total", "262144"],
     lambda r: r["vs_baseline"] == 1.0
     and r["detail"]["launches"]["K2"] > 0),
]


def phase_bench_runner(torch, gpu):
    """Phase 21: ``python -m simplex_tpu_torch.bench`` for every mode, each
    a subprocess that must exit 0 and print one JSON line, logged here,
    whose gate must hold: every batched instance optimal, the dense solve
    optimal, PDHG's converged share at phase 17's gate (200 of 256), every
    instance of the PDHG stream converged or recovered, the exact stream
    all certified; the kernels the mode runs launched."""
    from simplex_tpu_torch.runtime import graphs

    # The card's memory goes to the subprocesses.
    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    walls = {}
    for label, flags, gate in BENCH_MODES:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "simplex_tpu_torch.bench", *flags],
            cwd=root, capture_output=True, text=True, timeout=600)
        walls[label] = time.perf_counter() - t0
        lines = out.stdout.splitlines()
        check(out.returncode == 0 and len(lines) == 1,
              f"bench {flags}: exit {out.returncode}, {len(lines)} lines; "
              f"{out.stdout[-2000:]} {out.stderr[-4000:]}")
        rec = json.loads(lines[0])
        log(f"[bench] {label} on {gpu}, {walls[label]!r} s: {lines[0]}")
        check(gate(rec), f"bench {flags}: the mode's gate failed")
    return walls


# Phase 22: many users at once on one card, every request through the web
# app: users of the form on the three anchors (``/new`` and ``/solve``)
# and users who upload a netlib-scale MPS file (``/load`` and ``/solve``).
# The app serves with its report's pivot history capped at LOAD_HISTORY
# (``SIMPLEX_TPU_MAX_HISTORY``, read by ``SolverConfig.from_env``): at the
# default 64 a netlib-scale ``/solve`` renders a page of about 400 MB on
# the host (ROADMAP.md Queue 3 item 7).  The mix: one upload for every
# seven form users in the waves, three over HTTP, fifteen in the
# sustained stretch.  The form is the app's front page and the common
# request; an upload holds the interpreter and the one device stream for
# seconds, and a larger share would take the phase past its share of the
# run's time limit.  (a) LOAD_USERS threads in process, one request each,
# in two waves (the second meets what the first left in the graph cache),
# then a sustained stretch; (b) the same kinds of request over HTTP; (c)
# library callers at full width, with a stream sweep beside their
# captures.
LOAD_USERS = 16
LOAD_NETLIB = 8
LOAD_HISTORY = 2
LOAD_SUSTAIN_S = 20.0
LOAD_RATE = 4.0                # arrivals a second in the sustained stretch
HTTP_USERS = 8
LIBRARY_SEEDS = (0, 1, 2, 3)   # phase 5's generator, one LP each ...
LIBRARY_SIZE = 2048            # ... at phase 5's size
LIBRARY_BATCH = 16384          # phase 8's batch
SWEEP_CHUNKS = 4               # the sweep of (c): bench_stream_exact's
SWEEP_CHUNK = 16384            # generator, 4 batches of 16384 x (30x50)
_SUMMARY = re.compile(r'<section class="solution-summary.*?</section>', re.S)
_FLASH = re.compile(r'<div class="flash flash-[a-z]+">(.*?)</div>', re.S)
_SOLVE_ERROR = "Error durante la resolución"


def web_netlib_mps(mps, seed, box=50.0):
    """The MPS text of ``utils/mps.py::generate_netlib_adversarial(seed)``
    with its free columns boxed, as the web's ``/load`` takes no free
    column: FR to [-box, box], MI to [-box, inf).  The planted point
    (|x0| <= 20 on those columns) stays feasible."""
    out = []
    for line in mps.generate_netlib_adversarial(seed).splitlines():
        f = line.split()
        if len(f) == 3 and f[0] in ("FR", "MI") and f[1] == "BND":
            out.append(f" LO BND {f[2]} {-box:g}")
            if f[0] == "FR":
                out.append(f" UP BND {f[2]} {box:g}")
        else:
            out.append(line)
    return "\n".join(out) + "\n"


def _highs_bounds(lp, presolve):
    """(status, z) of HiGHS on an LP with bounds."""
    from scipy.optimize import linprog

    le, ge, eq = lp.ops == -1, lp.ops == 1, lp.ops == 0
    ref = linprog(-lp.c if lp.maximize else lp.c,
                  A_ub=np.vstack([lp.A[le], -lp.A[ge]]),
                  b_ub=np.concatenate([lp.b[le], -lp.b[ge]]),
                  A_eq=lp.A[eq] if eq.any() else None,
                  b_eq=lp.b[eq] if eq.any() else None,
                  bounds=list(zip(lp.lb, np.where(np.isfinite(lp.ub), lp.ub,
                                                  None))),
                  method="highs", options={"presolve": presolve})
    if ref.status != 0:
        return ref.status, None
    return 0, -ref.fun if lp.maximize else ref.fun


def load_problems(mps):
    """The first LOAD_NETLIB seeds of :func:`web_netlib_mps` on which HiGHS
    with and without presolve agree (an oracle that disagrees with itself
    anchors nothing): ``[(seed, MPS text, lp, z_ref)]``, and the seeds left
    out with both of HiGHS's answers."""
    out, skipped, seed = [], [], 0
    while len(out) < LOAD_NETLIB:
        check(seed < 4 * LOAD_NETLIB, f"HiGHS agrees with itself on "
              f"{len(out)} of the first {seed} seeds")
        text = web_netlib_mps(mps, seed)
        lp = mps.parse_mps(text)
        check(not lp.has_free, f"seed {seed}: free columns left")
        on, off = _highs_bounds(lp, True), _highs_bounds(lp, False)
        if on[0] == off[0] == 0 and _gate(on[1], off[1]):
            out.append((seed, text, lp, on[1]))
        else:
            skipped.append((seed, on, off))
        seed += 1
    return out, skipped


def _anchor_form(obj, rows):
    """An anchor of phase 4 as the web's ``/new`` form."""
    form = {"problem_type": obj["type"],
            "objective[]": [repr(v) for v in obj["coefficients"].values()],
            "constraint_sign[]": [op for _, op, _ in rows],
            "constraint_rhs[]": [repr(rhs) for _, _, rhs in rows]}
    for j in range(len(obj["coefficients"])):
        form[f"constraint_{j + 1}[]"] = [repr(a[j]) for a, _, _ in rows]
    return form


def _page(code1, page1, code2, page2, flash_page=""):
    """What a web user got: the answer (the page's solution summary) or,
    for a failure, why."""
    answer = _SUMMARY.search(page2) if code2 == 200 else None
    if code1 == 200 and "Vista previa" in page1 and answer is not None:
        return {"answer": answer.group(0)}
    flashes = [m.strip() for m in _FLASH.findall(flash_page or page2)]
    return {"answer": None,
            "error": f"{code1}/{code2}: {flashes or page2[-300:]!r}"}


def _web_inproc(app, TestClient, kind):
    """One web user in process, on a fresh client: ``/new`` with the
    anchor's form or ``/load`` with the MPS file, then ``/solve``."""
    client = TestClient(app)
    if kind[0] == "anchor":
        r1 = client.post("/new", data=kind[2])
    else:
        r1 = client.post("/load",
                         files={"problem_file": ("netlib.mps", kind[2])})
    r2 = client.post("/solve")
    flash = client.get("/").text if r2.status_code in (301, 302) else ""
    return _page(r1.status_code, r1.text, r2.status_code, r2.text, flash)


def _web_http(base, kind):
    """One web user over HTTP, with a client and a cookie jar of its own
    (redirects followed, as a browser does)."""
    import http.cookiejar
    import urllib.error
    import urllib.parse
    import urllib.request

    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))
    if kind[0] == "anchor":
        first = urllib.request.Request(base + "/new", data=urllib.parse.
                                       urlencode(kind[2], doseq=True).encode())
    else:
        boundary = f"simplexload{os.urandom(8).hex()}"
        first = urllib.request.Request(
            base + "/load",
            data=(f'--{boundary}\r\nContent-Disposition: form-data; '
                  f'name="problem_file"; filename="netlib.mps"\r\n'
                  f'Content-Type: application/octet-stream\r\n\r\n'
                  f'{kind[2]}\r\n--{boundary}--\r\n').encode(),
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
    try:
        with opener.open(first, timeout=600) as r1:
            code1, page1 = r1.status, r1.read().decode("utf-8")
        with opener.open(base + "/solve", data=b"", timeout=600) as r2:
            code2, page2 = r2.status, r2.read().decode("utf-8")
            moved = not r2.geturl().endswith("/solve")
    except urllib.error.HTTPError as e:
        return {"answer": None, "error": f"HTTP {e.code}: {e.read()[:300]!r}"}
    if moved:                       # a flash and a redirect
        return _page(code1, page1, 302, "", page2)
    return _page(code1, page1, code2, page2)


def _http_server(app):
    """``app`` behind a threading WSGI server on a free local port (the
    role of gunicorn's threaded workers): ``(server, thread, base URL)``."""
    import socketserver
    from wsgiref.simple_server import (WSGIRequestHandler, WSGIServer,
                                       make_server)

    class Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class Handler(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    server = make_server("127.0.0.1", 0, app, server_class=Server,
                         handler_class=Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _timed(request, kind):
    """``(outcome, seconds)`` of one request; an exception is a failed
    outcome."""
    t0 = time.perf_counter()
    try:
        out = request(kind)
    except Exception as exc:                    # logged by _hold
        out = {"answer": None, "error": repr(exc)}
    return out, time.perf_counter() - t0


def _users(request, kinds, timeout=900):
    """``request(kind)`` for every kind at once, one thread each, started
    together; ``[(kind, (outcome, seconds))]``."""
    out = [None] * len(kinds)
    barrier = threading.Barrier(len(kinds))

    def user(i):
        barrier.wait(timeout=60)
        out[i] = _timed(request, kinds[i])

    threads = [threading.Thread(target=user, args=(i,))
               for i in range(len(kinds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in threads), "a user thread hung")
    return list(zip(kinds, out))


def _sustained(request, kinds, seconds, rate, timeout=900):
    """Arrivals at ``rate`` a second for ``seconds``, each a new thread
    with the next kind in turn; ``([(kind, (outcome, seconds))], seconds
    from the last arrival to the last answer)``."""
    out, lock, threads = [], threading.Lock(), []

    def user(kind):
        res = _timed(request, kind)
        with lock:
            out.append((kind, res))

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = threading.Thread(target=user,
                             args=(kinds[len(threads) % len(kinds)],))
        t.start()
        threads.append(t)
        time.sleep(max(0.0, len(threads) / rate
                       - (time.perf_counter() - t0)))
    t1 = time.perf_counter()
    for t in threads:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in threads), "a user thread hung")
    return out, time.perf_counter() - t1


def _latencies(results):
    """p50, p95 and max seconds of each kind of request."""
    out = {}
    for name in ("anchor", "netlib"):
        s = sorted(dt for kind, (_, dt) in results if kind[0] == name)
        if s:
            out[name] = {"p50": s[math.ceil(0.5 * len(s)) - 1],
                         "p95": s[math.ceil(0.95 * len(s)) - 1],
                         "max": s[-1]}
    return out


def _hold(label, results, solo):
    """Fail on any request that got no answer or another answer than the
    same request served alone; log each failure's message first."""
    bad = [(kind[:2], out["error"] if out["answer"] is None
            else "an answer other than the request's alone")
           for kind, (out, _) in results if out["answer"] != solo[kind[:2]]]
    for what, why in bad:
        log(f"[load] {label}: {what} failed: {why}")
    errors = sum(_SOLVE_ERROR in why for _, why in bad)
    check(not bad, f"{label}: {len(bad)} of {len(results)} requests "
          f"failed ({errors} with a flashed solve error)")


def _rss():
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS line in /proc/self/status")


def _library_calls(pt, lps, batch):
    """The calls of (c): ``solve_lp`` of LP ``i``, the batch through
    ``solve_arrays``, and the sweep through ``solve_arrays_stream``; each
    returns what is held bit-equal."""
    cfg = pt.SolverConfig(device="cuda")
    solver = pt.BatchedSimplexSolver(cfg)

    def lp_call(i):
        r = pt.solve_lp(lps[i], cfg)
        return {"status": r.status, "basis": np.asarray(r.basis),
                "nit": r.nit, "z": r.z}

    def batch_call():
        res = solver.solve_arrays(*batch, maximize=True)
        return {"status": np.asarray(res.status), "z": np.asarray(res.z),
                "nit": res.nit}

    def sweep_call():
        out = list(pt.solve_arrays_stream(
            stream_chunks(SWEEP_CHUNKS, SWEEP_CHUNK, 30, 50, 300), cfg))
        return {"status": np.concatenate([np.asarray(r.status) for r in out]),
                "z": np.concatenate([np.asarray(r.z) for r in out]),
                "nit": [r.nit for r in out]}

    return lp_call, batch_call, sweep_call


def _same_result(a, b):
    return a.keys() == b.keys() and all(
        _same_bits(a[k], b[k]) if isinstance(a[k], np.ndarray)
        else a[k] == b[k] for k in a)


# The anchors of .claude/skills/verify/SKILL.md: (objective, rows, Z).
LOAD_ANCHORS = [
    ({"type": "maximize", "coefficients": {"x1": 15.0, "x2": 18.0}},
     [([4.0, 2.0], "<=", 2000.0), ([2.0, 6.0], "<=", 2400.0),
      ([20.0, 28.0], "<=", 14000.0)], 9833.3333),
    ({"type": "minimize", "coefficients": {"x1": 50.0, "x2": 80.0}},
     [([4.0, 1.0], ">=", 4.0), ([1.0, 6.0], ">=", 6.0),
      ([4.0, 6.0], ">=", 12.0)], 153.3333),
    ({"type": "minimize", "coefficients": {"x1": 2.0, "x2": 3.0}},
     [([1.0, 1.0], ">=", 5.0), ([2.0, 1.0], ">=", 8.0)], 10.0)]


def load_mixes(problems):
    """Phase 22's kinds of request, ``(kind, key, form or MPS text)``, its
    known answers by ``(kind, key)`` and its mixes.  The waves: every
    eighth user uploads (the first two LPs), the others fill in the
    anchors' forms in turn.  Over HTTP: every fourth (the third and fourth
    LPs).  The sustained stretch: every sixteenth arrival (the fifth LP
    on, in turn)."""
    kinds_a = [("anchor", k, _anchor_form(obj, rows))
               for k, (obj, rows, _) in enumerate(LOAD_ANCHORS)]
    kinds_n = [("netlib", seed, text) for seed, text, _, _ in problems]
    z_ref = {("netlib", seed): z for seed, _, _, z in problems}
    z_ref.update({("anchor", k): z
                  for k, (_, _, z) in enumerate(LOAD_ANCHORS)})
    return {
        "anchors": kinds_a, "netlib": kinds_n, "z_ref": z_ref,
        "waves": [kinds_n[i // 8 % LOAD_NETLIB] if i % 8 == 0
                  else kinds_a[i % 3] for i in range(LOAD_USERS)],
        "http": [kinds_n[(2 + i // 4) % LOAD_NETLIB] if i % 4 == 0
                 else kinds_a[i % 3] for i in range(HTTP_USERS)],
        "stretch": [kinds_n[(4 + j // 16) % LOAD_NETLIB] if j % 16 == 15
                    else kinds_a[j % 3] for j in range(16 * LOAD_NETLIB)]}


def phase_load(torch, pt, pivot_kernel, bk, gpu):
    """Phase 22: many users on the card at once; returns the kernels'
    launches over the phase."""
    from simplex_tpu_torch.runtime import graphs
    from simplex_tpu_torch.services.storage import StorageService
    from simplex_tpu_torch.utils import mps
    from simplex_tpu_torch.web.app import init_app
    from simplex_tpu_torch.web.microweb import TestClient

    t_phase = time.perf_counter()
    pivot_kernel.LAUNCHES = bk.LAUNCHES = bk.LAUNCHES_K3 = 0
    graphs.clear()
    problems, skipped = load_problems(mps)
    log(f"[load] netlib-scale LPs: seeds {[p[0] for p in problems]} of "
        f"web_netlib_mps (shapes {[p[2].A.shape for p in problems]}); left "
        f"out, HiGHS with and without presolve disagreeing: {skipped}")
    mix = load_mixes(problems)
    kinds_a, kinds_n, z_ref = mix["anchors"], mix["netlib"], mix["z_ref"]
    waves, http_mix, stretch = mix["waves"], mix["http"], mix["stretch"]
    # Both apps, in process and the WSGI module's, read the cap from the
    # environment as a deployment sets it.
    check("simplex_tpu_torch.web_app" not in sys.modules,
          "the WSGI module was imported before its history cap was set")
    os.environ["SIMPLEX_TPU_MAX_HISTORY"] = str(LOAD_HISTORY)
    try:
        app = init_app()
        import simplex_tpu_torch.web_app as web_app
    finally:
        del os.environ["SIMPLEX_TPU_MAX_HISTORY"]

    def inproc(kind):
        return _web_inproc(app, TestClient, kind)

    # Every request alone first: its answer, checked against the known Z
    # (anchors) or HiGHS, from the report it saved.
    store = StorageService()
    solo, solo_s = {}, {}
    for kind in kinds_a + kinds_n:
        out, solo_s[kind[:2]] = _timed(inproc, kind)
        check(out["answer"] is not None,
              f"{kind[:2]} alone: no answer ({out.get('error')})")
        ref = z_ref[kind[:2]]
        sol = store.load_solution()["solucion_encontrada"]
        z = sol["valor_optimo_z"]
        ok = sol["status"] == "Solucion Factible" and (
            round(z, 4) == ref if kind[0] == "anchor" else _gate(ref, z))
        check(ok, f"{kind[:2]} alone: {sol['status']}, z={z!r}, expected "
              f"{ref!r}")
        solo[kind[:2]] = out["answer"]
    log(f"[load] each request alone on {gpu}: seconds {solo_s}; anchors at "
        f"their Z, the netlib-scale LPs optimal with z within 1e-6 (1+|z|) "
        f"of HiGHS (history capped at {LOAD_HISTORY} pivots)")

    # (c)'s calls alone: results, K1 and K2 launches and seconds.
    lps = []
    for seed in LIBRARY_SEEDS:
        c, A, b = dense_lp(LIBRARY_SIZE, seed)
        lps.append(pt.LinearProgram(c=c, A=A, b=b,
                                    ops=np.full(LIBRARY_SIZE, -1),
                                    maximize=True))
    lp_call, batch_call, sweep_call = _library_calls(
        pt, lps, bench_batch(LIBRARY_BATCH))
    calls = {i: (lambda i=i: lp_call(i)) for i in range(len(lps))}
    calls.update(batch=batch_call, sweep=sweep_call)
    lib_solo, lib_solo_s, k_solo = {}, {}, {}
    for name, fn in calls.items():
        k1, k2 = pivot_kernel.LAUNCHES, bk.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lib_solo[name] = fn()
        torch.cuda.synchronize()
        lib_solo_s[name] = time.perf_counter() - t0
        k_solo[name] = (pivot_kernel.LAUNCHES - k1, bk.LAUNCHES - k2)
    k1_solo = sum(k[0] for k in k_solo.values())
    k2_solo = sum(k[1] for k in k_solo.values())
    check(k_solo["batch"][1] == lib_solo["batch"]["nit"],
          f"the batch alone: K2 {k_solo['batch'][1]}, iterations "
          f"{lib_solo['batch']['nit']}")
    log(f"[load] (c) each call alone on {gpu}: seconds {lib_solo_s}; "
        f"launches (K1, K2) {k_solo}, the batch's K2 = its iterations; "
        f"statuses {[lib_solo[i]['status'] for i in range(len(lps))]}, "
        f"pivots {[lib_solo[i]['nit'] for i in range(len(lps))]}")

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0 = _rss()
    walls = {}

    def part(label, results, caps, reps, t0, note=""):
        walls[label] = time.perf_counter() - t0
        _hold(label, results, solo)
        n = len(results)
        log(f"[load] {label}{note} on {gpu}: {n} requests, every answer "
            f"equal to its request alone; wall {walls[label]!r} s; latency "
            f"{_latencies(results)}; captures {(graphs.CAPTURES - caps) / n!r}"
            f" and replays {(graphs.REPLAYS - reps) / n!r} a request; cache "
            f"{len(graphs.stats())} entries, {graphs.cache_bytes()} bytes")

    # (a) every user at once, one request each, twice; then the sustained
    # stretch.
    for wave in (1, 2):
        caps, reps, t0 = graphs.CAPTURES, graphs.REPLAYS, time.perf_counter()
        part(f"(a) wave {wave}", _users(inproc, waves), caps, reps, t0)
    caps, reps, t0 = graphs.CAPTURES, graphs.REPLAYS, time.perf_counter()
    res, drain = _sustained(inproc, stretch, LOAD_SUSTAIN_S, LOAD_RATE)
    part("(a) sustained", res, caps, reps, t0,
         f", {LOAD_SUSTAIN_S} s at {LOAD_RATE} arrivals/s (the last answer "
         f"{drain!r} s after the last arrival)")

    # (b) the same kinds of request over HTTP, against the WSGI module's
    # app.  An upload's answer sets a session cookie of about 1.3 MB (the
    # app keeps the problem in its signed cookie, as the reference does:
    # ROADMAP.md Queue 3 item 7), longer than the 64 KiB header line that
    # the standard library's HTTP server and client read, so the limit is
    # lifted for (b), as gunicorn takes such a cookie only under
    # ``--limit-request-field_size 0``.
    import http.client

    server, thread, base = _http_server(web_app.app)
    maxline, http.client._MAXLINE = http.client._MAXLINE, 1 << 24
    try:
        caps, reps, t0 = graphs.CAPTURES, graphs.REPLAYS, time.perf_counter()
        res = _users(lambda kind: _web_http(base, kind), http_mix)
    finally:
        http.client._MAXLINE = maxline
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    part("(b) over HTTP", res, caps, reps, t0)

    # (c) library callers at full width: each thread one solve_lp, the
    # last one the batch first; one more thread the sweep.
    n = len(LIBRARY_SEEDS)

    def call(i):
        if i == n:
            return {"sweep": sweep_call()}
        got = {"batch": batch_call()} if i == n - 1 else {}
        got[i] = lp_call(i)
        return got

    k1, k2 = pivot_kernel.LAUNCHES, bk.LAUNCHES
    caps, t0 = graphs.CAPTURES, time.perf_counter()
    res = _users(call, list(range(n + 1)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = pivot_kernel.LAUNCHES - k1, bk.LAUNCHES - k2
    for i, (got, _) in res:
        check("error" not in got, f"(c): call {i} raised: {got.get('error')}")
        for name, r in got.items():
            check(_same_result(r, lib_solo[name]),
                  f"(c): {name} under load differs from alone")
    check(k1 == k1_solo, f"(c): K1 {k1} under load, {k1_solo} alone")
    check(k2 == k2_solo, f"(c): K2 {k2} under load, {k2_solo} alone")
    log(f"[load] (c) on {gpu}: {n} solve_lp calls ({LIBRARY_SIZE}^2), the "
        f"{LIBRARY_BATCH} x (30x50) batch and a sweep of {SWEEP_CHUNKS} x "
        f"{SWEEP_CHUNK} at once: each bit-equal to its call alone; K1 {k1} "
        f"and K2 {k2} = alone; wall {wall!r} s, each thread "
        f"{[dt for _, (_, dt) in res]!r} s; captures "
        f"{graphs.CAPTURES - caps}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = (pivot_kernel.LAUNCHES, bk.LAUNCHES, bk.LAUNCHES_K3)
    log(f"[load] phase 22 on {gpu}: {time.perf_counter() - t_phase!r} s "
        f"(parts {walls}); peak device memory {peak / 2**30!r} GiB, host "
        f"RSS growth {(_rss() - rss0) / 2**20!r} MiB, cache "
        f"{len(graphs.stats())} entries, {graphs.cache_bytes()} bytes; "
        f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on "
                           "a GPU and has no CPU path")
    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    os.environ["SIMPLEX_TPU_OUTPUT_DIR"] = tmp.name
    import simplex_tpu_torch as pt
    from simplex_tpu_torch import cli
    from simplex_tpu_torch.models.batched import compile_batch_uniform
    from simplex_tpu_torch.ops import batched_kernel as bk
    from simplex_tpu_torch.ops import certify_kernel as ck
    from simplex_tpu_torch.ops import pivot_kernel
    from simplex_tpu_torch.ops import stream_kernel as sk
    from simplex_tpu_torch.runtime import kernels
    from simplex_tpu_torch.services import storage as storage_mod
    from simplex_tpu_torch.utils import profiling

    # 1. environment
    gpu = _gpu_line()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    log(f"[env] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"driver {driver.split()[0]}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s), python "
        f"{sys.version.split()[0]}")

    # The profiler's tracing starts before any CUDA graph exists: it
    # reports every pass of a WHILE node's body (a chunk's steps) only in
    # graphs instantiated after its first session, and phases 8, 11, 14,
    # 17, 19 and 20 read the kernels of replayed chunks.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

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
    k1_times = phase_k1_timing(torch, pivot_kernel, gpu)
    k1 = k1_times[(10240, 10240)]

    # 4. report path through the CLI, each report logging its solve record
    pivot_kernel.LAUNCHES = 0
    profiling.DEFAULT_METRICS.records.clear()
    phase_cli(cli, storage_mod, tmp.name)
    log(f"[cli] K1 launches over the three reports: {pivot_kernel.LAUNCHES}")
    check(pivot_kernel.LAUNCHES >= 1, "the report path launched K1 no time")
    recs = profiling.DEFAULT_METRICS.records
    check(len(recs) == 3 and all(r.engine == "dense" and r.status == 0
                                 and r.n_vars == 2 for r in recs),
          f"the CLI left {len(recs)} solve records, not three optimal ones")
    log(f"[cli] solve records: {[r.to_json() for r in recs]}; summary "
        f"{profiling.DEFAULT_METRICS.summary()}")

    # 5. the main path at full size
    launches, basis_2048 = phase_solve(torch, pt, pivot_kernel, gpu)
    _graph_stats("phase 5")

    # 6. K2 against its twin, 7. timed
    k2_err = phase_k2(torch, bk, compile_batch_uniform)
    k2_times = phase_k2_timing(torch, bk, sk, compile_batch_uniform, gpu)
    k2 = k2_times[16384]

    # 8. the batched path at full width
    k2_launches, cert = phase_batched(torch, pt, bk, ck, gpu)
    _graph_stats("phase 8")

    # 9. K3 against its twin, 10. timed
    t_k3 = time.perf_counter()
    k3_err = phase_k3(torch, bk, compile_batch_uniform)
    k3_times = phase_k3_timing(torch, bk, sk, compile_batch_uniform, gpu)
    k3 = k3_times[16384]

    # 11. the bounded path at full width; (b) the mknapcb9.relax cell's
    # path, K3 streaming its tiles in float32 and in the float64 finish
    k3_launches = phase_bounded(torch, pt, bk, gpu)
    k3_mknap, cert_bounded = phase_mknap(torch, pt, bk, ck,
                                         compile_batch_uniform, gpu)
    _graph_stats("phase 11")

    # 12. K4 against its twin, 13. timed, the pivot-rate path, and every
    # kernel's share restated against K4's measured in-place ceiling
    t_k4 = time.perf_counter()
    k4_err = phase_k4(torch, sk)
    k4_times = phase_k4_timing(torch, sk, gpu)
    detail, k4_launches = phase_pivot_rate(torch, pivot_kernel, sk, gpu)
    k4 = k4_times[(10241, 10241)]
    # The ceiling is K4's chain of 64 launches in the pivot-rate run: a
    # single launch timed from an idle card (phase 13) also carries the
    # wrapper's host latency.
    ceiling = detail["k4_stream_GBps"]
    single = 2 * 10241 * 10241 * 4 / k4["k4_in"] / 1e6
    log(f"[ceiling] K4 in place at 10241^2, chained: {ceiling!r} GB/s = "
        f"{ceiling / (HBM_BYTES_PER_S / 1e9)!r} of the published "
        f"{HBM_BYTES_PER_S / 1e9!r} GB/s (one launch: {single!r} GB/s; "
        f"chained out of place {detail['k4_outofplace_GBps']!r} GB/s; "
        f"torch add_ {detail['empirical_stream_GBps']!r}, add(out=) "
        f"{detail['xla_outofplace_GBps']!r} GB/s)")
    # K1 chained, so its share does not carry one launch's host latency.
    rows = [(f"K1 {R}x{W} chained", t["chain"], t["bound"], t["bound_by"])
            for (R, W), t in k1_times.items()]
    # K2 and K3 chained: 16 steps from the first tableau, the bound the
    # mean of their own bytes.
    rows += [(f"{name} B={B} chained", t["chain"], t["chain_bound"],
              t["chain_bound_by"])
             for name, times in (("K2", k2_times), ("K3", k3_times))
             for B, t in times.items()]
    rows += [("K4 10241^2 in place", k4["k4_in"], k4["bound"],
              k4["bound_by"]),
             ("K4 16384x32x128 in place",
              k4_times[(16384, 32, 128)]["k4_in"],
              k4_times[(16384, 32, 128)]["bound"],
              k4_times[(16384, 32, 128)]["bound_by"])]
    for name, ms, b_ms, b_by in rows:
        nbytes = b_ms * HBM_BYTES_PER_S / 1e3
        at_ceiling = nbytes / (ceiling * 1e6)
        log(f"[share] {name} on {gpu}: {ms!r} ms; bound {b_ms!r} ms "
            f"({b_by}) = {b_ms / ms!r} of it at 3.35 TB/s; at K4's "
            f"measured ceiling the same bytes take {at_ceiling!r} ms = "
            f"{at_ceiling / ms!r} of it")

    # 14. MPS files through every engine, and the revised engine at full
    # width; 15. the web app and the remaining commands
    t_mps = time.perf_counter()
    phase_mps(torch, cli, pivot_kernel, tmp.name, gpu)
    phase_revised(torch, pt, gpu)
    _graph_stats("phase 14")
    t_web = time.perf_counter()
    phase_web(torch, cli, pivot_kernel, profiling, gpu)
    _graph_stats("phase 15")

    # 16. the dual reoptimizer (K1), 17. PDHG, 18. the PDHG stream with
    # crossover (K2 in the batched recovery), 19. the batched stream (K2,
    # K3)
    t_new = time.perf_counter()
    k1_dual = phase_reoptimize(torch, pt, pivot_kernel, gpu, basis_2048)
    k1_dual_b = phase_reoptimize_bounded(torch, pt, pivot_kernel, gpu)
    _graph_stats("phase 16")
    t_pdhg = time.perf_counter()
    phase_pdhg(torch, pt, gpu)
    _graph_stats("phase 17")
    t_pstream = time.perf_counter()
    k2_pdhg = phase_pdhg_stream(torch, pt, bk, pivot_kernel, gpu)
    _graph_stats("phase 18")
    t_bstream = time.perf_counter()
    k2_stream, k3_stream = phase_batched_stream(torch, pt, bk, gpu, tmp.name)
    _graph_stats("phase 19")
    log(f"[path] launches on phases 16-19's paths: K1 {k1_dual} (phase 16 a) "
        f"and {k1_dual_b} (16 b); K2 {k2_pdhg} (phase 18's recovery) and "
        f"{k2_stream} (phase 19's mixed stream); K3 {k3_stream} (phase 19)")

    # 20. the row-sharded path through a one-rank NCCL group
    t_sharded = time.perf_counter()
    k1_sharded = phase_sharded(torch, pt, pivot_kernel, bk, sk, gpu, tmp.name)
    _graph_stats("phase 20")
    log(f"[path] launches on phase 20's path: K1 {k1_sharded} "
        f"(bench_sharded's comparison at 8192^2); K2, K3 and K4 none")

    # 21. the measurement runner, every mode
    t_bench = time.perf_counter()
    walls = phase_bench_runner(torch, gpu)

    # 22. many users at once: the web app in process and over HTTP, and
    # library callers at full width
    t_load = time.perf_counter()
    load_launches = phase_load(torch, pt, pivot_kernel, bk, gpu)
    _graph_stats("phase 22")
    tmp.cleanup()
    t_end = time.perf_counter()
    log(f"[done] phases 1-22 in {t_end - t_start!r} s, of which phases "
        f"1-8 {t_k3 - t_start!r} s, 9-11 {t_k4 - t_k3!r} s, 12-13 "
        f"{t_mps - t_k4!r} s, 14 {t_web - t_mps!r} s, 15 "
        f"{t_new - t_web!r} s, 16 {t_pdhg - t_new!r} s, 17 "
        f"{t_pstream - t_pdhg!r} s, 18 {t_bstream - t_pstream!r} s, 19 "
        f"{t_sharded - t_bstream!r} s, 20 {t_bench - t_sharded!r} s, 21 "
        f"{t_load - t_bench!r} s "
        f"({', '.join(f'{k.split()[0]} {v:.1f}' for k, v in walls.items())})"
        f" and 22 {t_end - t_load!r} s")
    log(f"[path] launches on phase 22's paths: K1 {load_launches[0]}, K2 "
        f"{load_launches[1]}, K3 {load_launches[2]}")

    log(json.dumps({"kernels": [{
        "name": "K1 pivot_update",
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/pivot_update.cu",
        "replaces": "simplex_tpu/ops/pallas_pivot.py:67",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1["one"],
        "plain_ms": k1["twin"],
        "bound_ms": k1["bound"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["addr_one"],
    }, {
        "name": "K2 fused_pivot_step",
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/fused_pivot_step.cu",
        "replaces": "simplex_tpu/ops/pallas_batched.py:404",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2["one"],
        "plain_ms": k2["twin"],
        "bound_ms": k2["bound"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "K3 fused_pivot_step_bounded",
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/fused_pivot_step_bounded.cu",
        "replaces": "simplex_tpu/ops/pallas_batched.py:501",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3["one"],
        "plain_ms": k3["twin"],
        "bound_ms": k3["bound"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }] + [{
        "name": "K3 fused_pivot_step_bounded {}x{}x{} {}, streamed".format(
            *t["shape"], dt),
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/fused_pivot_step_bounded.cu",
        "replaces": "simplex_tpu/ops/pallas_batched.py:501",
        "launches": t["launches"],
        "max_abs_err": t["err"],
        "ms": t["one"],
        "plain_ms": t["twin"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    } for dt, t in k3_mknap.items()] + [{
        "name": "K4 stream_copy",
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/stream_copy.cu",
        "replaces": "bench.py:229",
        "launches": k4_launches,
        "max_abs_err": k4_err,
        "ms": k4["k4_in"],
        "plain_ms": k4["twin_in"],
        "bound_ms": k4["bound"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["add_"],
    }] + [{
        "name": "Cert certify_le {}x{}x{}{}".format(
            *t["shape"], " bounded" if bounded else ""),
        "route": "cuda",
        "source": "simplex_tpu_torch/csrc/certify_bounded.cu",
        "replaces": "simplex_tpu/models/certify.py:309",
        "launches": t["launches"],
        "max_abs_err": t["err"],
        "ms": t["one"],
        "plain_ms": t["twin"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    } for bounded, t in ((False, cert), (True, cert_bounded))]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
