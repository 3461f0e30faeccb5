"""Row-sharded solves across cards, one process a rank: the layouts of
``parallel/sharded.py`` on real collectives, and BASELINE config 5.

    python -m simplex_tpu_torch.utils.sharded_cards [--ranks 4]
        [--device cuda|cpu] [--phases abcd] [--rows 100000]
        [--cut-rows 32768] [--lps FILE.npz] [--out DIR] [--timeout S]

The parent process spawns one worker a rank (this module again, with
``--worker``).  Each worker gets ``SIMPLEX_TPU_COORDINATOR`` (a ``file://``
store in a fresh directory), ``SIMPLEX_TPU_NUM_PROCESSES`` and
``SIMPLEX_TPU_PROCESS_ID`` and joins the group through
``parallel.distributed.initialize``, as a user's process would: NCCL with
one card a rank (the default), gloo with ``--device cpu``.  The parent
waits under its own time limit (``--timeout``); on a timeout, or as soon
as a worker exits non-zero, it kills every rank and exits non-zero, naming
the rank and the phase it was in.  Otherwise it prints one line a check
(``[check] {json}``), then one summary line (``[summary] {json}``) that
carries ``nvidia-smi``'s name and power limit of every card.  It refuses to
run (exit 2) on fewer cards than ranks; nothing runs on fewer ranks or on
the CPU in its place.  Every check that fails stops the run.

Phases (``--phases``, default all):

(a) collectives: MIN, MAX and SUM all-reduces and the all-gather over the
    world and over this rank's row group of a (2, 2) mesh (four ranks),
    at 2 elements (a pivot's packed minima) and 100,021 (config 5's pivot
    row), each run eagerly and inside a captured CUDA graph (one line),
    then inside the WHILE body of a chunk (``runtime/graphs.py``,
    ``csrc/graph_steps.cu``; a second line); each result equal to the
    host's, the node types each capture holds, microseconds a call;
(b) the sharded loop on the row layout (1, ranks), the replayed graphs
    against the eager chunks (``graphs._EAGER``): bit-equal outputs, steps
    equal to iterations, ``go`` equal across each row group after every
    chunk, and NCCL's kernels under ``torch.profiler`` for every step of a
    replayed solve (so in every pass of the WHILE body);
(c) every layout (b, r) with b * r = ranks: each LP's float32 solve
    through ``solve_arrays_sharded`` (statuses equal to HiGHS's, z within
    1e-6 (1 + |z|), every optimal instance certified), and its float64
    ``solve_tableau_sharded`` against the one-rank solve (no group) on
    rank 0's device: the same statuses, bases, iterations and at-upper
    columns, or the first step where they split and the objective rows'
    difference there;
(d) BASELINE config 5 (``--rows`` x 20, seed 42) on (1, ranks) through
    ``solve_arrays_sharded``, float32, ``max_iters=512``, certified:
    OPTIMAL, z within the gate of HiGHS; seconds by span, iterations, ms
    a pivot against the bound (the row block read and written once a
    pivot at 3.35 TB/s), NCCL calls a pivot and their share of the device
    time over one eager chunk, the busy share, peak device memory and
    peak host RSS of each rank, each rank's chunk by kernel and its update
    (``addr_``) alone against a streaming ``add_`` on its block; then the
    ``--cut-rows`` cut on (1, ranks) against the same solve on rank 0's
    device alone.

``--lps FILE.npz`` replaces (b)'s and (c)'s LPs with the file's (for each
name in its
``names`` array, ``{name}_c``, ``_A``, ``_b``, ``_ops``, ``_maximize``, and
optionally ``_ub`` and ``_max_iters``); ``--out DIR`` makes rank 0 write
(c)'s results there, one ``{b}x{r}_{name}.npz`` a layout and LP.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

# The card's published memory rate (H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
# The JAX package's record of config 5 (BENCH_sharded100k_r05.json: a
# (1, 2) virtual CPU mesh), a cross-check beside HiGHS.
JAX_CONFIG5_Z = 10.33922719

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------- LPs ---- #

def config5_lp(m=100_000, n=20, seed=42):
    """BASELINE config 5's generator (``tests/test_sharded.py:305-312``):
    A ~ U(0.05, 1), b = A x0 + U(0.05, 0.5), all ``<=``, maximized."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(1, m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    b = (A[0] @ x0 + rng.uniform(0.05, 0.5, size=m))[None, :]
    c = rng.uniform(0.1, 1.0, size=(1, n))
    return c, A, b, np.full(m, -1)


def many_pivot_lp(m=8192, n=192, seed=71):
    """``tests/test_sharded.py:173``'s LP: about n tight rows, hundreds of
    pivots."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(1, m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    slack = np.where(rng.random(m) < n / m * 1.5, 0.0,
                     rng.uniform(0.5, 5.0, size=m))
    b = (A[0] @ x0 + slack)[None, :]
    c = rng.uniform(0.1, 1.0, size=(1, n))
    return c, A, b, np.full(m, -1)


def mechanism_lp(m=16384, n=8, seed=33):
    """``tests/test_sharded.py:147``'s LP: an interior start, few pivots."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(1, m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=(1, m))
    c = rng.uniform(0.1, 1.0, size=(1, n))
    return c, A, b, np.full(m, -1)


def bound_flip_lp(B=2, m=256, n=12, seed=13):
    """``tests/test_sharded.py:248``'s tall bounded LPs (bound flips)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    x0 = rng.uniform(0.5, 1.5, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0) + rng.uniform(0.1, 0.8, (B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ub = np.where(rng.random((B, n)) < 0.7,
                  x0 * rng.uniform(0.7, 1.3, (B, n)), np.inf)
    return c, A, b, np.full(m, -1), ub


def mixed_batch(B=256, m=30, n=50, seed=11):
    """``tests/_torch_parity.py::seeded_lp``'s recipe at a fixed shape:
    mixed rows that hold at a random point, mixed cost signs (some
    unbounded), maximize or not an instance."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 3, size=(B, m, n)).round(2)
    x0 = rng.uniform(0, 2, size=(B, n))
    ops = rng.choice([-1, 0, 1], size=(B, m), p=[0.6, 0.15, 0.25])
    b = np.einsum("bmn,bn->bm", A, x0)
    slack = rng.uniform(0, 2, size=(B, m))
    b = np.where(ops == -1, b + slack, np.where(ops == 1, b - slack, b))
    c = rng.uniform(-1, 2, size=(B, n)).round(2)
    maximize = rng.integers(0, 2, size=B).astype(bool)
    return c, A, b, ops, maximize


def mixed_bounded_batch(B=256, m=30, n=50, seed=77):
    """``tests/test_bounds.py``'s native-bounds construction at a fixed
    shape: shared mixed rows, minimized, 60 % of the variables bounded."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)).round(2)
    x0 = rng.uniform(0.2, 2.0, size=(B, n))
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.einsum("bmn,bn->bm", A, x0) + np.where(
        ops == -1, slack, np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=(B, n)).round(2)
    ub = np.where(rng.random((B, n)) < 0.6,
                  x0 + rng.uniform(-0.3, 1.5, size=(B, n)).clip(0.01),
                  np.inf)
    return c, A, b, ops, ub


def _lp(c, A, b, ops, maximize, ub=None, max_iters=4096):
    return dict(c=c, A=A, b=b, ops=ops, maximize=maximize, ub=ub,
                max_iters=max_iters)


def loop_lps():
    """Phase (b)'s LPs (``chip_smoke.py`` phase 20 (b)), by name."""
    flip = bound_flip_lp()
    return {"8192x192": _lp(*many_pivot_lp(), True, max_iters=2048),
            "2x256x12_bounded": _lp(*flip[:4], True, ub=flip[4]),
            "16384x8": _lp(*mechanism_lp(), True, max_iters=64)}


def layout_lps():
    """Phase (c)'s LPs: (b)'s and the mixed classic and bounded batches of
    ``chip_smoke.py`` phases 8 and 11 at B = 256."""
    cu, Au, bu, opsu, ubu = mixed_bounded_batch()
    return dict(loop_lps(), mixed_256=_lp(*mixed_batch()),
                mixed_bounded_256=_lp(cu, Au, bu, opsu, False, ub=ubu))


def save_lps(path, lps):
    """Write ``lps`` ({name: LP dict}) as ``--lps`` reads them."""
    arrays = {"names": np.array(sorted(lps))}
    for name, lp in lps.items():
        for k, v in lp.items():
            if v is not None:
                arrays[f"{name}_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_lps(path):
    with np.load(path) as f:
        return {str(name): _lp(
            f[f"{name}_c"], f[f"{name}_A"], f[f"{name}_b"], f[f"{name}_ops"],
            f[f"{name}_maximize"],
            ub=f[f"{name}_ub"] if f"{name}_ub" in f else None,
            max_iters=int(f[f"{name}_max_iters"])
            if f"{name}_max_iters" in f else 4096)
            for name in f["names"]}


def highs(lp):
    """(statuses, z) of HiGHS on every instance of ``lp`` (presolve off:
    with it, HiGHS may call an unbounded LP infeasible)."""
    from scipy.optimize import linprog

    c, A, b = (np.asarray(lp[k], np.float64) for k in ("c", "A", "b"))
    B, m, n = A.shape
    ops = np.broadcast_to(np.asarray(lp["ops"]), (B, m))
    maxi = np.broadcast_to(np.asarray(lp["maximize"], bool), (B,))
    ub = (np.full((B, n), np.inf) if lp["ub"] is None
          else np.broadcast_to(np.asarray(lp["ub"], np.float64), (B, n)))
    status, z = np.zeros(B, np.int64), np.full(B, np.nan)
    for i in range(B):
        le, ge, eq = ops[i] == -1, ops[i] == 1, ops[i] == 0
        A_ub = np.vstack([A[i][le], -A[i][ge]])
        b_ub = np.concatenate([b[i][le], -b[i][ge]])
        ref = linprog(-c[i] if maxi[i] else c[i],
                      A_ub=A_ub if len(b_ub) else None,
                      b_ub=b_ub if len(b_ub) else None,
                      A_eq=A[i][eq] if eq.any() else None,
                      b_eq=b[i][eq] if eq.any() else None,
                      bounds=[(0, None if np.isinf(u) else float(u))
                              for u in ub[i]],
                      method="highs", options={"presolve": False})
        status[i] = ref.status
        if ref.status == 0:
            z[i] = -ref.fun if maxi[i] else ref.fun
    return status, z


def within_gate(z_ref, z):
    return bool(np.all(np.abs(z - z_ref) <= 1e-6 * (1.0 + np.abs(z_ref))))


# ------------------------------------------------------------- parent ---- #

def gpu_lines():
    """``nvidia-smi``'s name and power limit of every card, one line each
    (the empty list where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                p.kill()
    for p in procs:
        p.wait()


def _phase_of(work, rank):
    try:
        with open(os.path.join(work, f"rank{rank}.phase")) as f:
            return f.read().strip() or "start"
    except OSError:
        return "start"


def _tail(path, n=30):
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def _records(work, rank):
    path = os.path.join(work, f"rank{rank}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run(args) -> int:
    """The parent: spawn, wait, report.  Returns the exit code."""
    if args.device == "cuda":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.ranks:
            print(f"[refused] {args.ranks} ranks need {args.ranks} CUDA "
                  f"devices, {have} present; nothing runs in their place",
                  flush=True)
            return 2
    work = tempfile.mkdtemp(prefix="sharded_cards_")
    env = dict(os.environ, SIMPLEX_TPU_COORDINATOR=f"file://{work}/store",
               SIMPLEX_TPU_NUM_PROCESSES=str(args.ranks),
               PYTHONPATH=os.pathsep.join(
                   p for p in (_PKG_ROOT, os.environ.get("PYTHONPATH"))
                   if p))
    if args.device == "cpu":
        # Every rank is a process of this host.
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    argv = [sys.executable, "-u", "-m",
            "simplex_tpu_torch.utils.sharded_cards", "--worker", work, "--ranks", str(args.ranks), "--device",
            args.device, "--phases", args.phases, "--rows", str(args.rows),
            "--cut-rows", str(args.cut_rows)]
    if args.lps:
        argv += ["--lps", os.path.abspath(args.lps)]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        argv += ["--out", os.path.abspath(args.out)]
    t0 = time.perf_counter()
    procs = []
    for r in range(args.ranks):
        with open(os.path.join(work, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                argv, env=dict(env, SIMPLEX_TPU_PROCESS_ID=str(r)),
                cwd=_PKG_ROOT, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
    failure = None
    try:
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                failure = (f"rank {r} exited with code {codes[r]} in phase "
                           f"{_phase_of(work, r)}", r)
            elif all(c == 0 for c in codes):
                break
            elif time.perf_counter() - t0 > args.timeout:
                late = [r for r, c in enumerate(codes) if c is None]
                failure = ("time limit of " f"{args.timeout} s reached; "
                           + ", ".join(f"rank {r} in phase "
                                       f"{_phase_of(work, r)}"
                                       for r in late), late[0])
            else:
                time.sleep(0.2)
    finally:
        _kill(procs)
    seconds = time.perf_counter() - t0
    records = _records(work, 0) + [
        rec for r in range(1, args.ranks) for rec in _records(work, r)]
    for rec in records:
        print("[check] " + json.dumps(rec), flush=True)
    summary = {"ok": failure is None, "ranks": args.ranks,
               "device": args.device, "phases": args.phases,
               "checks": len(records), "seconds": seconds,
               "cards": gpu_lines() if args.device == "cuda" else []}
    if failure is not None:
        msg, r = failure
        summary["failure"] = msg
        print(f"[failed] {msg}; the end of rank {r}'s output:\n"
              + _tail(os.path.join(work, f"rank{r}.log")), flush=True)
    print("[summary] " + json.dumps(summary), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0 if failure is None else 1


# ------------------------------------------------------------- worker ---- #

class Worker:
    """One rank: its group, its device, its record file."""

    def __init__(self, args):
        import torch
        import torch.distributed as dist

        from ..parallel import distributed as pdist

        self.args = args
        self.work = args.worker
        self.rank = int(os.environ["SIMPLEX_TPU_PROCESS_ID"])
        self.world = int(os.environ["SIMPLEX_TPU_NUM_PROCESSES"])
        self.torch, self.dist = torch, dist
        self.phase("start")
        if args.device == "cuda":
            # The profiler reports every pass of a WHILE node's body only in
            # graphs instantiated after the process's first session.
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                pass
        else:
            torch.set_num_threads(1)
        self.phase("initialize")
        pdist.initialize(device=args.device)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if args.device == "cuda" else torch.device("cpu"))
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        self._highs, self._meshes = {}, {}

    def mesh(self, batch, row):
        """The (batch, row) mesh, made once (its groups are created
        collectively, in the same order on every rank)."""
        from ..parallel import sharded as psh

        if (batch, row) not in self._meshes:
            self._meshes[batch, row] = psh.make_mesh(batch=batch, row=row)
        return self._meshes[batch, row]

    def phase(self, name):
        self.current = name
        with open(os.path.join(self.work, f"rank{self.rank}.phase"), "w") as f:
            f.write(name)

    def record(self, check, ok=True, every_rank=False, **data):
        """One check's line (rank 0's, or every rank's where
        ``every_rank``); a failed check stops this rank."""
        if self.rank == 0 or every_rank:
            rec = {"phase": self.current, "check": check, "ok": bool(ok)}
            if every_rank:
                rec["rank"] = self.rank
            rec.update(data)
            with open(os.path.join(self.work, f"rank{self.rank}.jsonl"),
                      "a") as f:
                f.write(json.dumps(rec, default=_plain) + "\n")
        if not ok:
            raise RuntimeError(f"check failed in phase {self.current}: "
                               f"{check}: {data}")

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (a MIN over the world)."""
        t = self.torch.tensor([int(bool(flag))], device=self.device)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MIN)
        return bool(t.item())

    def highs(self, name, lp):
        if name not in self._highs:
            self._highs[name] = highs(lp)
        return self._highs[name]

    def timer(self):
        """A function returning the seconds since it was made, the device
        synchronised."""
        self.sync()
        t0 = time.perf_counter()

        def stop():
            self.sync()
            return time.perf_counter() - t0
        return stop


def _plain(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def _layouts(ranks):
    return [(b, ranks // b) for b in range(1, ranks + 1) if ranks % b == 0]


# (a) collectives -------------------------------------------------------- #

_SIZES = (2, 100_021)


def _inputs(torch, rank, size, device):
    """This rank's integer-valued float32 input (exact under any sum)."""
    return (torch.arange(size, dtype=torch.float32) % 7 + 3 * rank
            + 1).to(device)


def _expected(kind, ranks, size, steps=1):
    """The host's result of ``steps`` rounds of collective ``kind`` over
    ``ranks``, each round on the inputs raised by its index, summed."""
    acc = None
    for k in range(steps):
        xs = [np.arange(size, dtype=np.float64) % 7 + 3 * r + 1 + k
              for r in ranks]
        y = {"sum": np.sum(xs, axis=0), "min": np.min(xs, axis=0),
             "max": np.max(xs, axis=0),
             "gather": np.concatenate(xs)}[kind]
        acc = y if acc is None else acc + y
    return acc.astype(np.float32)


def _collective(kind, x, group, n):
    """One collective of ``kind`` on ``x`` (not written) over ``group``:
    the all-reduce's or the all-gather's output, flat."""
    from ..parallel import sharded as psh

    if kind == "gather":
        return psh._gather(x, group, n).reshape(-1)
    op = {"sum": psh._SUM, "min": psh._MIN, "max": psh._MAX}[kind]
    return psh._reduce(x.clone(), op, group)


def _collective_steps(st, cs, static, n_steps):
    """A chunk whose every step runs one collective on ``st["x"]``, adds
    its output to ``st["acc"]`` and raises ``x`` by one (the WHILE body
    case of phase (a))."""
    from ..runtime import graphs

    kind, group, n = static
    for _ in graphs.steps(st, n_steps):
        st["acc"].add_(_collective(kind, st["x"], group, n))
        st["x"].add_(1)


def phase_collectives(w):
    """(a): every collective eagerly, in a graph and in a WHILE body."""
    from ..runtime import graphs

    torch, dist = w.torch, w.dist
    w.phase("a")
    groups = [("world", dist.group.WORLD, list(range(w.world)))]
    if w.world == 4:
        mesh = w.mesh(2, 2)
        members = [mesh.batch_index * 2 + k for k in range(2)]
        groups.append(("row group of (2,2)", mesh.row_group, members))
    # On the CPU the times are not the card's: fewer repetitions.
    reps, loop_steps = (20, 32) if w.cuda else (2, 4)
    for gname, group, members in groups:
        n = len(members)
        for kind in ("min", "max", "sum", "gather"):
            for size in _SIZES:
                x = _inputs(torch, w.rank, size, w.device)
                want = _expected(kind, members, size)
                label = f"{kind} over the {gname} ({n} ranks), {size} f32"
                # Eager.
                y = _collective(kind, x, group, n)
                ok = np.array_equal(y.cpu().numpy(), want)
                stop = w.timer()
                for _ in range(reps):
                    _collective(kind, x, group, n)
                eager_us = stop() / reps * 1e6
                rec = {"eager_us": eager_us}
                ok = w.agree(ok)
                # One captured graph of one call, replayed.
                if w.cuda:
                    g = torch.cuda.CUDAGraph(keep_graph=True)
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        g.capture_begin(capture_error_mode="thread_local")
                        yg = _collective(kind, x, group, n)
                        g.capture_end()
                    torch.cuda.current_stream().wait_stream(side)
                    rec["graph_nodes"] = graphs.node_types(g.raw_cuda_graph())
                    g.instantiate()
                    g.replay()
                    ok = w.agree(ok and np.array_equal(yg.cpu().numpy(),
                                                       want))
                    stop = w.timer()
                    for _ in range(reps):
                        g.replay()
                    rec["graph_us"] = stop() / reps * 1e6
                    del g
                w.record(f"{label}: eager and in a captured graph, equal to "
                         "the host's", ok, **rec)
                # Inside a chunk's WHILE body: a warm-up and capture, then
                # a replay of `loop_steps` steps.
                rec = {}
                out_n = size * (n if kind == "gather" else 1)
                for _ in ("capture", "replay"):
                    state = {"x": x.clone(), "acc": torch.zeros(
                        out_n, dtype=torch.float32, device=w.device),
                        **graphs.step_state(w.device)}
                    steps = graphs.STEPS
                    stop = w.timer()
                    with graphs.Loop("sharded_cards.collective", state, {},
                                     (kind, group, n)) as lp:
                        lp.run(_collective_steps, loop_steps)
                        lp.read()
                    secs = stop()
                    got = state["acc"].cpu().numpy()
                    ok = w.agree(ok and graphs.STEPS - steps == loop_steps
                                 and np.array_equal(got, _expected(
                                     kind, members, size, loop_steps)))
                rec["while_us_a_step"] = secs / loop_steps * 1e6
                parts = graphs.captured_parts("sharded_cards.collective")
                if parts:
                    rec["while_parts"] = [p for _, ps in parts for p in ps]
                graphs.clear()
                w.record(f"{label}: {loop_steps} steps of a chunk's WHILE "
                         "body equal to the host's", ok, **rec)


# (b) the loop, graphs against eager ---------------------------------- #

def _stage(w, lp, mesh, dtype):
    """``lp``'s arguments of ``solve_tableau_sharded`` for ``mesh``, staged
    on this rank's device, and whether it is bounded (the host's tableau is
    dropped on return)."""
    from ..parallel import sharded as psh

    _, arrays, bounded = psh.compile_sharded(
        lp["c"], lp["A"], lp["b"], lp["ops"], lp["maximize"],
        mesh.shape["batch"], mesh.shape["row"], dtype=dtype, ub=lp["ub"])
    return psh.stage_shards(arrays, mesh, w.device), bounded


def _whole(mesh, out):
    """Rank-local ``solve_tableau_sharded`` outputs gathered into the whole
    batch, as numpy: basis, obj, status and at_upper, with iters."""
    from ..parallel import sharded as psh

    _, basis, obj, status, iters, at_up = out
    return {"basis": psh._gather_batch(psh._gather_rows(basis, mesh),
                                       mesh).cpu().numpy(),
            "obj": psh._gather_batch(obj.contiguous(), mesh).cpu().numpy(),
            "status": psh._gather_batch(status, mesh).cpu().numpy(),
            "at_upper": psh._gather_batch(at_up, mesh).cpu().numpy(),
            "iters": int(iters)}


class _ChunkFlags:
    """The ``go`` flag of the sharded loop after each chunk, as the host
    reads it (its one read a chunk, ``graphs.Loop.read``)."""

    def __enter__(self):
        from ..runtime import graphs

        self.flags, self._read = [], graphs.Loop.read
        flags, read = self.flags, self._read

        def logged(lp, *vals, **kw):
            out = read(lp, *vals, **kw)
            if lp.name == "sharded.body":
                flags.append(bool(lp.state["go"]))
            return out

        graphs.Loop.read = logged
        return self

    def __exit__(self, *exc):
        from ..runtime import graphs

        graphs.Loop.read = self._read
        return False


def _device_events(w, fn):
    """``fn()`` under ``torch.profiler``: its result, its wall seconds, the
    device's (us, count, name) of every kernel and copy, and the process
    group's calls on the host by name (count, host ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if w.cuda
                                     else [])
    with profile(activities=acts) as prof:
        stop = w.timer()
        out = fn()
        wall = stop()
    device, host = [], {}
    prefix = w.dist.get_backend() + ":"
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0 and not ev.key.startswith("aten::"):
                device.append((us, ev.count, ev.key))
        elif ev.key.startswith(prefix):
            host[ev.key] = (ev.count, ev.cpu_time_total / 1e3)
    return out, wall, device, host


def _same_bits(torch, a, b):
    if isinstance(a, int):
        return a == b
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8)))


def phase_loop(w, lps):
    """(b): the row layout's loop through graphs and eagerly, bit for bit."""
    from ..parallel import sharded as psh
    from ..runtime import graphs

    w.phase("b")
    mesh = w.mesh(1, w.world)
    for name, lp in lps.items():
        args, bounded = _stage(w, lp, mesh, np.float32)

        def solve():
            return psh.solve_tableau_sharded(
                *args, mesh=mesh, max_iters=lp["max_iters"], bounded=bounded)

        runs = []
        for mode in "EGG":
            graphs._EAGER = mode == "E"
            try:
                steps = graphs.STEPS
                with _ChunkFlags() as flags:
                    stop = w.timer()
                    out = solve()
                    secs = stop()
            finally:
                graphs._EAGER = False
            runs.append((mode, out, graphs.STEPS - steps, flags.flags, secs))
        ref = runs[0][1]
        same = all(_same_bits(w.torch, a, b)
                   for _, out, _, _, _ in runs[1:] for a, b in zip(ref, out))
        steps_ok = all(s == out[4] for _, out, s, _, _ in runs)
        # The flags of every rank of this row group, chunk by chunk.
        row_flags = [None] * mesh.shape["row"]
        w.dist.all_gather_object(row_flags, [f for _, _, _, f, _ in runs],
                                 group=mesh.row_group)
        flags_ok = all(f == row_flags[0] for f in row_flags)
        # A replayed solve under the profiler: NCCL's kernels a step (the
        # CPU has no device timeline).
        steps, wall, device = 0, 0.0, []
        if w.cuda:
            steps = graphs.STEPS
            _, wall, device, _ = _device_events(w, solve)
            steps = graphs.STEPS - steps
        nccl = sum(n for _, n, key in device if "nccl" in key.lower())
        nccl_ok = w.world == 1 or nccl >= 4 * steps
        ok = w.agree(same and steps_ok and flags_ok and nccl_ok)
        w.record(f"(1,{w.world}) {name}: graphs bit-equal to eager chunks "
                 "(T, basis, obj, status, iters, at_upper), steps = "
                 "iterations, go equal across the row group after every "
                 "chunk, NCCL kernels in every step of a replayed solve",
                 ok, iters=ref[4], steps=[s for _, _, s, _, _ in runs],
                 chunks=len(runs[0][3]),
                 seconds={"eager": runs[0][4], "graphs_first": runs[1][4],
                          "graphs": runs[2][4]},
                 profiled={"wall_s": wall, "steps": steps,
                           "nccl_kernels": nccl,
                           "nccl_us": sum(us for us, _, key in device
                                          if "nccl" in key.lower()),
                           "device_us": sum(us for us, _, _ in device)},
                 bit_equal=same, flags_equal=flags_ok)
        del args, runs, ref
        graphs.clear()


# (c) every layout ------------------------------------------------------ #

def _compare(one, multi, B, iters=True):
    """Whether two gathered float64 solves are step-equal on the first B
    instances (statuses, bases on the real rows, at-upper columns, z within
    1e-9 (1 + |z|)) and, where ``iters``, in their iterations (a batch
    axis above 1 returns batch shard 0's count)."""
    m = min(one["basis"].shape[1], multi["basis"].shape[1])
    n = min(one["at_upper"].shape[1], multi["at_upper"].shape[1])
    z1, z2 = one["obj"][:B, -1], multi["obj"][:B, -1]
    return ((not iters or one["iters"] == multi["iters"])
            and np.array_equal(one["status"][:B], multi["status"][:B])
            and np.array_equal(one["basis"][:B, :m], multi["basis"][:B, :m])
            and np.array_equal(one["at_upper"][:B, :n],
                               multi["at_upper"][:B, :n])
            and bool(np.all(np.abs(z1 - z2) <= 1e-9 * (1 + np.abs(z1)))))


def _one_rank(w, lp, max_iters):
    """Rank 0's float64 solve of ``lp`` with no group (the 1x1 mesh whose
    collectives are the identity), gathered as :func:`_whole` gives."""
    from ..parallel import sharded as psh

    mesh = psh.Mesh(1, 1)
    args, bounded = _stage(w, lp, mesh, np.float64)
    return _whole(mesh, psh.solve_tableau_sharded(
        *args, mesh=mesh, max_iters=max_iters, bounded=bounded))


def _first_split(w, lp, mesh, hi):
    """The first step after which the layout's float64 solve and the
    one-rank solve differ (they agree after 0 steps and differ after
    ``hi``), found by bisection on ``max_iters``; every rank takes part.
    Returns (step, what differs there) on rank 0."""
    from ..parallel import sharded as psh

    B = np.shape(lp["A"])[0]
    lo, info = 0, {}
    while hi - lo > 1:
        mid = (lo + hi) // 2
        args, bounded = _stage(w, lp, mesh, np.float64)
        multi = _whole(mesh, psh.solve_tableau_sharded(
            *args, mesh=mesh, max_iters=mid, bounded=bounded))
        del args
        verdict = [None]
        if w.rank == 0:
            one = _one_rank(w, lp, mid)
            same = _compare(one, multi, B, mesh.shape["batch"] == 1)
            verdict = [same]
            if same:
                d = np.abs(one["obj"][:B] - multi["obj"][:B])
                info = {"obj_row_max_abs_diff_before": float(d.max())}
        w.dist.broadcast_object_list(verdict, src=0)
        lo, hi = (mid, hi) if verdict[0] else (lo, mid)
    return hi, info


def phase_layouts(w, lps):
    """(c): every layout's float32 gate and float64 step-equality."""
    from ..parallel import sharded as psh
    from ..runtime import graphs

    w.phase("c")
    refs = {}
    for nb, nr in _layouts(w.world):
        mesh = w.mesh(nb, nr)
        for name, lp in lps.items():
            B = np.shape(lp["A"])[0]
            stop = w.timer()
            out = psh.solve_arrays_sharded(
                lp["c"], lp["A"], lp["b"], lp["ops"],
                maximize=lp["maximize"], mesh=mesh,
                max_iters=lp["max_iters"], certify=True, ub=lp["ub"],
                device=w.args.device)
            secs = stop()
            args, bounded = _stage(w, lp, mesh, np.float64)
            multi = _whole(mesh, psh.solve_tableau_sharded(
                *args, mesh=mesh, max_iters=lp["max_iters"],
                bounded=bounded))
            del args
            gate = same = True
            data = {}
            if w.rank == 0:
                st_ref, z_ref = w.highs(name, lp)
                opt = st_ref == 0
                gate = (np.array_equal(out["status"], st_ref)
                        and within_gate(z_ref[opt], out["z"][opt])
                        and bool(np.all(out["certified"][opt])))
                if name not in refs:
                    refs[name] = _one_rank(w, lp, lp["max_iters"])
                one = refs[name]
                same = _compare(one, multi, B, nb == 1)
                st64 = multi["status"][:B]
                gate = gate and np.array_equal(st64, one["status"][:B])
                data = {"statuses": np.bincount(out["status"],
                                                minlength=4)[:4],
                        "iters_f32": out["iters"],
                        "iters_f64": multi["iters"],
                        "one_rank_iters_f64": one["iters"],
                        "certified": int(np.sum(out["certified"])),
                        "escalated": int(np.sum(out["escalated"])),
                        "max_abs_z_err": float(np.max(
                            np.abs(out["z"][opt] - z_ref[opt]),
                            initial=0.0)),
                        "seconds_f32": secs}
                if w.args.out:
                    np.savez(os.path.join(w.args.out,
                                          f"{nb}x{nr}_{name}.npz"),
                             **{k: np.asarray(v) for k, v in multi.items()},
                             **{f"f32_{k}": np.asarray(out[k]) for k in
                                ("x", "z", "status", "certified")})
            verdict = [same]
            w.dist.broadcast_object_list(verdict, src=0)
            if not verdict[0]:
                step, info = _first_split(w, lp, mesh, lp["max_iters"])
                data["split"] = dict(step=step, **info)
            w.record(f"({nb},{nr}) {name}: statuses equal to HiGHS's, z "
                     "within 1e-6 (1+|z|), optimal ones certified; float64 "
                     "step-equal to one rank" + ("" if verdict[0] else
                                                 " (split recorded)"),
                     w.agree(gate), **data)
        graphs.clear()


# (d) config 5 -------------------------------------------------------- #

_SPANS = ("sharded.assemble", "sharded.stage", "sharded.solve",
          "sharded.extract", "sharded.certify")


def _peak_rss_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _spans(w, fn):
    """``fn()`` under a host-only profiler: its result, wall seconds and
    the seconds of each ``sharded.*`` span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stop = w.timer()
        out = fn()
        wall = stop()
    return out, wall, {ev.key: ev.cpu_time_total / 1e6
                       for ev in prof.key_averages() if ev.key in _SPANS}


def _config5_gate(w, rows, label):
    """``solve_arrays_sharded`` on config 5's generator at ``rows`` on (1,
    ranks), gated on HiGHS; its spans, iterations and peak memory."""
    from ..parallel import sharded as psh

    torch = w.torch
    c, A, b, ops = config5_lp(rows)
    mesh = w.mesh(1, w.world)
    if w.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res, wall, secs = _spans(w, lambda: psh.solve_arrays_sharded(
        c, A, b, ops, maximize=True, mesh=mesh, max_iters=512,
        certify=True, device=w.args.device))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if w.cuda else None
    w.record(f"{label}: this rank's peak memory", every_rank=True,
             peak_device_gib=peak, peak_host_rss_gib=_peak_rss_gib())
    ok, data = True, {}
    if w.rank == 0:
        st, z = highs(_lp(c, A, b, ops, True))
        ok = (res["status"][0] == 0 == st[0] and bool(res["certified"][0])
              and within_gate(z, res["z"]))
        data = {"z": float(res["z"][0]), "z_highs": float(z[0]),
                "iters": res["iters"], "escalated": bool(res["escalated"][0]),
                "wall_s": wall, "spans_s": secs}
    return w.agree(ok), data, (c, A, b, ops)


def _update_alone(w, T, reps=5):
    """ms a launch of ``T.addr_`` (the step's rank-1 update, on zeros so
    the block keeps its values) and of ``T.add_(0.0)`` (a plain streaming
    pass) over the block ``T``, and their rates (read and write once)."""
    if not w.cuda:
        return {}
    torch = w.torch
    col = torch.zeros(T.shape[0], dtype=T.dtype, device=T.device)
    row = torch.zeros(T.shape[1], dtype=T.dtype, device=T.device)
    out = {}
    for name, fn in (("addr_", lambda: T.addr_(col, row, alpha=-1)),
                     ("add_", lambda: T.add_(0.0))):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        out[f"{name}_ms"] = ms
        out[f"{name}_TBps"] = 2 * T.numel() * T.element_size() / ms / 1e9
    return out


def phase_config5(w):
    """(d): config 5 at ``--rows`` on (1, ranks), then the ``--cut-rows``
    cut against rank 0's device alone."""
    from ..parallel import sharded as psh
    from ..runtime import graphs

    torch = w.torch
    w.phase("d")
    rows, R = w.args.rows, w.world
    ok, data, lp = _config5_gate(w, rows, f"config 5, {rows} rows on (1,{R})")
    if w.rank == 0:
        data["jax_record_z"] = JAX_CONFIG5_Z
    # The loop alone on staged shards: ms a pivot, then one eager chunk
    # under the profiler (NCCL's calls and device time, the update's).
    mesh = w.mesh(1, R)
    args = _stage(w, _lp(*lp, True), mesh, np.float32)[0]
    m_loc, n1 = args[0].shape[1:]
    bound_ms = 2 * m_loc * n1 * args[0].element_size() / HBM_BYTES_PER_S \
        * 1e3
    steps = graphs.STEPS
    stop = w.timer()
    out = psh.solve_tableau_sharded(*args, mesh=mesh, max_iters=512)
    secs = stop()
    steps = graphs.STEPS - steps
    steps_ok = steps == out[4]
    ms_pivot = secs / max(out[4], 1) * 1e3
    n = psh._CHUNK
    graphs._EAGER = True
    try:
        _, wall, device, host = _device_events(w, lambda: (
            psh.solve_tableau_sharded(*args, mesh=mesh, max_iters=n,
                                      refactor_every=n + 1)))
    finally:
        graphs._EAGER = False
    dev_us = sum(us for us, _, _ in device)
    nccl_us = sum(us for us, _, key in device if "nccl" in key.lower())
    upd_us = sum(us for us, _, key in device if "addr" in key
                 or "gemm" in key.lower())
    calls = sum(c for c, _ in host.values())
    # Each rank's chunk (a rank that waits in NCCL for a slower one shows
    # it there), and the update alone on this rank's block: addr_ and the
    # streaming add_ over the same bytes, 5 launches each on CUDA events.
    alone = _update_alone(w, args[0][0])
    w.record(f"config 5, {rows} rows on (1,{R}): this rank's eager chunk "
             "and its update alone", every_rank=True,
             device_ms=dev_us / 1e3, nccl_ms=nccl_us / 1e3,
             update_ms=upd_us / 1e3, **alone,
             top=[(us / 1e3, c, key[:90])
                  for us, c, key in sorted(device, reverse=True)[:6]])
    del args, out
    data.update({
        "solve_tableau_s": secs, "steps": steps,
        "ms_a_pivot": ms_pivot, "bound_ms_a_pivot": bound_ms,
        "bound_share": bound_ms / ms_pivot,
        "eager_chunk": {"steps": n, "wall_s": wall,
                        "device_ms": dev_us / 1e3,
                        "busy": dev_us / 1e6 / wall,
                        "collective_calls_a_pivot": calls / n,
                        "collectives_host": host,
                        "nccl_device_share": nccl_us / max(dev_us, 1e-9),
                        "update_device_share": upd_us / max(dev_us, 1e-9)},
        "graph_busy": dev_us / 1e3 / n / ms_pivot})
    ok = w.agree(ok and steps_ok)
    w.record(f"config 5, {rows} x 20 (seed 42) on (1,{R}), float32, "
             "max_iters 512: OPTIMAL, certified, z within 1e-6 (1+|z|) of "
             "HiGHS; steps = iterations", ok, **data)
    graphs.clear()
    if w.cuda:
        torch.cuda.empty_cache()

    # The cut one card holds: (1, ranks) against rank 0's card alone.
    cut = w.args.cut_rows
    ok, data, lp = _config5_gate(w, cut, f"config 5 cut to {cut} rows on "
                                         f"(1,{R})")
    times = {}
    for key, m in (("ranks", mesh), ("one_card", psh.Mesh(1, 1))):
        if key == "one_card" and w.rank != 0:
            continue
        args = _stage(w, _lp(*lp, True), m, np.float32)[0]
        runs = []
        for _ in range(4):
            stop = w.timer()
            psh.solve_tableau_sharded(*args, mesh=m, max_iters=512)
            runs.append(stop())
        times[key] = sorted(runs[1:])
        del args
        graphs.clear()
        if w.cuda:
            torch.cuda.empty_cache()
    w.dist.barrier()
    if w.rank == 0:
        data["solve_tableau_s"] = times
        data["speedup_median"] = times["one_card"][1] / times["ranks"][1]
    w.record(f"config 5 cut to {cut} rows on (1,{R}): OPTIMAL, certified, "
             "z within the gate; solve_tableau_sharded against one card "
             "(3 timed after a warm one each)", ok, **data)


# ---------------------------------------------------------------- main ---- #

def work(args) -> int:
    """One rank's phases; any exception ends the process with code 1
    without waiting for the others (the parent kills them)."""
    import traceback

    try:
        w = Worker(args)
        lps = load_lps(args.lps) if args.lps else None
        if "a" in args.phases:
            phase_collectives(w)
        if "b" in args.phases:
            phase_loop(w, lps or loop_lps())
        if "c" in args.phases:
            phase_layouts(w, lps or layout_lps())
        if "d" in args.phases:
            phase_config5(w)
        w.phase("end")
        from ..runtime import graphs

        w.sync()
        graphs.clear()
        w.dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.utils.sharded_cards",
        description="Row-sharded solves across cards, one process a rank.")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--phases", default="abcd")
    p.add_argument("--rows", type=int, default=100_000,
                   help="config 5's rows in phase (d)")
    p.add_argument("--cut-rows", type=int, default=32_768,
                   help="the cut of config 5 that one card holds")
    p.add_argument("--lps", help="an .npz of LPs for phases (b) and (c)")
    p.add_argument("--out", help="rank 0 writes (c)'s results here")
    p.add_argument("--timeout", type=float, default=1500.0,
                   help="seconds before every rank is killed")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return work(args)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
