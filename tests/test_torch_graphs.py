"""The solve loops' CUDA graphs (``simplex_tpu_torch/runtime/graphs.py``).

On the CPU: the cache's key and eviction and the launch-count arithmetic,
on a stub in place of a real CUDA graph; every loop's chunk body, run
eagerly chunk by chunk, against the results each loop gave before its
chunk became a body of its own (float64, recorded as hashes of the
outputs' bits); the batched stream's private callback, once a batch, after
the previous batch's first chunk.  On the card (``gpu``): every loop run
as replayed graphs against the same loop run eagerly, bit for bit, with
the same kernel launches; and the replayed chunks' launches held to the
steps the loops need (no kernel after a chunk's verdict).  No span opens
inside a chunk body, and a capture and each host read are spans of the
solve (``utils/profiling.py``).  Nothing here imports JAX, so on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_graphs.py -m gpu --noconftest
"""
import collections
import time

import numpy as np
import pytest
import torch

import _torch_loop_cases as loop_cases
from _torch_loop_cases import CASES, fingerprint
from _torch_parity import CPU, MIXED_OPS, random_batch

from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.models import batched as tmb
from simplex_tpu_torch.models import revised as t_rev
from simplex_tpu_torch.ops import batched as tb
from simplex_tpu_torch.ops import batched_kernel, pivot_kernel
from simplex_tpu_torch.ops import tableau as tt
from simplex_tpu_torch.runtime import counters, graphs, staging
from simplex_tpu_torch.utils import profiling

# Each case of _torch_loop_cases.py in float64 on the CPU, as the loops
# computed it before their chunks were factored into bodies; the bounded
# cases' T as it is since the bounded refactor sets the basic columns
# exactly (within 3.6e-15 of the earlier T, every other output unchanged).
GOLDEN = {
    'batched_le': {
        'T': 'float64[12, 16, 128]:563459ea6380820d',
        'basis': 'int32[12, 15]:050eb5a46c1ea0f2',
        'iters': 'int64[]:a111f275cc2e7588',
        'pivots': 'int32[12]:c486c71028018cc0',
        'status': 'int32[12]:17b0761f87b081d5',
    },
    'batched_mixed': {
        'T': 'float64[12, 16, 128]:99583249eff980d8',
        'basis': 'int32[12, 15]:7fba58ab9f59cdb4',
        'iters': 'int64[]:9bb57922dc1a9aa3',
        'pivots': 'int32[12]:0826013541605b38',
        'status': 'int32[12]:c6bb82fa5848ee9d',
    },
    'batched_mixed_unfused': {
        'T': 'float64[12, 16, 128]:99583249eff980d8',
        'basis': 'int32[12, 15]:7fba58ab9f59cdb4',
        'iters': 'int64[]:9bb57922dc1a9aa3',
        'pivots': 'int32[12]:0826013541605b38',
        'status': 'int32[12]:c6bb82fa5848ee9d',
    },
    'bounded_le': {
        'T': 'float64[12, 16, 128]:347c77dc87c23ec6',
        'at_upper': 'bool[12, 127]:54abd4be9837da6f',
        'basis': 'int32[12, 15]:d2571d4e5d71f378',
        'iters': 'int64[]:5fd1b79ebdef9619',
        'pivots': 'int32[12]:1da85713f2777041',
        'status': 'int32[12]:17b0761f87b081d5',
    },
    'bounded_mixed': {
        'T': 'float64[12, 16, 128]:003e3bb6f8af5706',
        'at_upper': 'bool[12, 127]:23b6e150ff35fa8e',
        'basis': 'int32[12, 15]:16629ea10128bbdb',
        'iters': 'int64[]:e48d939f60d90eb5',
        'pivots': 'int32[12]:7d1c7b2b0118ea16',
        'status': 'int32[12]:27571db2bb62a14d',
    },
    'bounded_mixed_unfused': {
        'T': 'float64[12, 16, 128]:003e3bb6f8af5706',
        'at_upper': 'bool[12, 127]:23b6e150ff35fa8e',
        'basis': 'int32[12, 15]:16629ea10128bbdb',
        'iters': 'int64[]:e48d939f60d90eb5',
        'pivots': 'int32[12]:7d1c7b2b0118ea16',
        'status': 'int32[12]:27571db2bb62a14d',
    },
    'dense_phase': {
        'T': 'float64[32, 80]:45b81d46f666cd8d',
        'basis': 'int64[31]:e404429300015d6b',
        'iters': 'int64[]:8bf3cd6bb2af61dd',
        'status': 'int64[]:af5570f5a1810b7a',
    },
    'dense_phase_dantzig': {
        'T': 'float64[32, 56]:608b87eb1c5fe721',
        'basis': 'int64[31]:15ef67ccb5e10fec',
        'iters': 'int64[]:35e3a6176b50da27',
        'status': 'int64[]:af5570f5a1810b7a',
    },
    'dual': {
        'T': 'float64[32, 128]:3007dffac7c89185',
        'basis': 'int64[31]:b1d5c56d5f9e52f1',
        'iters': 'int64[]:35be322d094f9d15',
        'status': 'int64[]:af5570f5a1810b7a',
    },
    'dual_bounded': {
        'T': 'float64[32, 48]:9be131638e902cab',
        'at_upper': 'bool[47]:c9d56535e9e80a5a',
        'basis': 'int64[31]:6a5cfed58942e039',
        'iters': 'int64[]:aae89fc0f03e2959',
        'status': 'int64[]:af5570f5a1810b7a',
    },
    'pdhg': {
        'done': 'bool[8]:d4591cb6ac4aec03',
        'dual': 'float64[8]:85ae4529c606402c',
        'gap': 'float64[8]:d486c0f1de760a13',
        'iters': 'int64[]:6471415615703edd',
        'primal': 'float64[8]:01a59d0bb1c65074',
        'x': 'float64[8, 6]:44a9bb5e87ff2b59',
        'y': 'float64[8, 10]:70645e4b01e5ffc4',
    },
    'pdhg_classic': {
        'done': 'bool[8]:41b8f24b79ae38bb',
        'dual': 'float64[8]:c99cd885931a9ff3',
        'gap': 'float64[8]:0e3972182a55538f',
        'iters': 'int64[]:6471415615703edd',
        'primal': 'float64[8]:42588c5a27ae6e2d',
        'x': 'float64[8, 6]:bb5f42d5b8f1e891',
        'y': 'float64[8, 10]:19007d11969faf24',
    },
    'revised': {
        'B_inv0': 'float64[39, 39]:f0c82562ff4cd371',
        'B_inv1': 'float64[39, 39]:ebece5f02b163238',
        'at_upper0': 'bool[79]:ca46a2b5ef093bf0',
        'at_upper1': 'bool[79]:ca46a2b5ef093bf0',
        'basis0': 'int64[39]:8596b2001d134b60',
        'basis1': 'int64[39]:0f4330d0c9ca809c',
        'iters0': 'int64[]:c5b2e76e0be88460',
        'iters1': 'int64[]:8e9bcd43f7a4b257',
        'obj0': 'float64[]:af5570f5a1810b7a',
        'obj1': 'float64[]:d0a06fcb46de584e',
        'status0': 'int64[]:af5570f5a1810b7a',
        'status1': 'int64[]:af5570f5a1810b7a',
        'x_B0': 'float64[39]:0a06e73af103f1a4',
        'x_B1': 'float64[39]:42f8a02923c91da3',
    },
    'sharded': {
        'T': 'float64[8, 48, 129]:64cc2c5590cd3969',
        'at_upper': 'bool[8, 128]:74d3b53425d48344',
        'basis': 'int32[8, 48]:c20a84c13f73dd28',
        'iters': 'int64[]:e398142931ca52d6',
        'obj': 'float64[8, 129]:6f6b840c407ad002',
        'status': 'int32[8]:66687aadf862bd77',
    },
    'sharded_classic': {
        'T': 'float64[4, 40, 129]:ce2514d214aa42b2',
        'at_upper': 'bool[4, 128]:076a27c79e5ace2a',
        'basis': 'int32[4, 40]:95f1c5d94df76dfa',
        'iters': 'int64[]:ee5d1a3591fb90a9',
        'obj': 'float64[4, 129]:21761fb1a1aa04f4',
        'status': 'int32[4]:374708fff7719dd5',
    },
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_bodies_give_the_loops_recorded_results(case):
    before = graphs.EAGER_CHUNKS
    assert fingerprint(CASES[case](CPU, torch.float64)) == GOLDEN[case]
    assert graphs.EAGER_CHUNKS - before >= 2      # several chunks ran


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_span_opens_inside_a_chunk_body(case, monkeypatch):
    """Spans sit at stage boundaries: no ``record_function`` opens while
    a loop's chunk body runs (the body a CUDA graph captures)."""
    real_run, real_span = graphs.Loop.run, torch.profiler.record_function
    running, ran, opened = [], [], []

    def span(name, *args, **kwargs):
        if running:
            opened.append(name)
        return real_span(name, *args, **kwargs)

    def run(self, body, *args):
        def watched(*a):
            running.append(1)
            ran.append(1)
            try:
                return body(*a)
            finally:
                running.pop()
        return real_run(self, watched, *args)

    monkeypatch.setattr(torch.profiler, "record_function", span)
    monkeypatch.setattr(graphs.Loop, "run", run)
    with profiling.solve_record("loop.case"):
        CASES[case](CPU, torch.float64)
    assert len(ran) >= 2 and opened == []


class _StubGraph:
    """A CUDA graph's contract on the CPU: the warm-up runs the chunk, the
    capture records it and runs nothing (its writes are dropped), a replay
    runs it and, like a replay on the card, no Python wrapper."""

    fail = False

    def __init__(self, device, pool):
        self.fn = None

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        if _StubGraph.fail:
            raise RuntimeError("capture refused")
        store = graphs._store
        graphs._store = lambda *a: None
        try:
            fn()
        finally:
            graphs._store = store
        self.fn = fn
        return 0

    def replay(self):
        counts = graphs._own_counters()
        self.fn()
        graphs._add_counters([a - b for a, b in
                              zip(counts, graphs._own_counters())])


@pytest.fixture
def stub(monkeypatch):
    """The graph path on CPU tensors, with the stub for the graphs and a
    fresh cache and counters."""
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", _StubGraph)
    monkeypatch.setattr(graphs, "_new_pool", lambda device: None)
    monkeypatch.setattr(graphs, "_CACHE", collections.OrderedDict())
    for name in ("REPLAYS", "CAPTURES", "EAGER_CHUNKS"):
        monkeypatch.setattr(graphs, name, 0)
    monkeypatch.setattr(_StubGraph, "fail", False)
    monkeypatch.setattr(pivot_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(batched_kernel, "LAUNCHES_K3", 0)
    return graphs


def _toy(st, cs, static, n):
    """A chunk of ``n`` steps that each "launch" K1 twice and K3 once and
    add ``inc * scale`` to ``k``."""
    k = st["k"]
    for _ in range(n):
        counters.add(vars(pivot_kernel), "LAUNCHES", 2)
        counters.add(vars(batched_kernel), "LAUNCHES_K3")
        k = k + cs["inc"] * static[0]
    return {"k": k}


def _solve(chunks, n=3, size=4, scale=1.0, name="toy"):
    k = torch.zeros(size, dtype=torch.float64)
    with graphs.Loop(name, {"k": k}, {"inc": torch.ones(size)},
                     (scale,)) as lp:
        for _ in range(chunks):
            lp.run(_toy, n)
    return k


def test_replays_add_the_launches_their_capture_enqueued(stub):
    k = _solve(5)
    assert torch.equal(k, torch.full((4,), 15.0, dtype=torch.float64))
    # One warm-up chunk and four replays; the capture counts nothing.
    assert (stub.CAPTURES, stub.REPLAYS, stub.EAGER_CHUNKS) == (1, 4, 1)
    assert pivot_kernel.LAUNCHES == 5 * 3 * 2
    assert batched_kernel.LAUNCHES_K3 == 5 * 3


def test_a_capture_and_each_host_read_are_spans_of_the_solve(stub,
                                                             monkeypatch):
    """A new variant's capture is one ``graphs.capture`` span, which holds
    the capture and not the eager warm-up before it (where a new process
    builds its kernels); each host read is one ``graphs.read``; replays
    add no span."""
    times = {}

    def timed(name, call):
        def run(self, fn):
            t0 = time.perf_counter()
            out = call(self, fn)
            times[name] = (t0, time.perf_counter())
            return out
        return run

    monkeypatch.setattr(_StubGraph, "warm_up",
                        timed("warm_up", _StubGraph.warm_up))
    monkeypatch.setattr(_StubGraph, "capture",
                        timed("capture", _StubGraph.capture))
    state = {"k": torch.zeros(4, dtype=torch.float64),
             "steps": torch.zeros((), dtype=torch.int64)}
    before = profiling.span_stats().get("graphs.capture", {"count": 0})
    with profiling.solve_record("toy.solve") as rec:
        with graphs.Loop("toy.spans", state, {"inc": torch.ones(4)},
                         (1.0,)) as lp:
            for _ in range(3):
                lp.run(_toy, 2)
                lp.read()
    assert torch.equal(state["k"], torch.full((4,), 6.0,
                                              dtype=torch.float64))
    assert [(n, p) for n, p, _, _ in rec["spans"]] == [
        ("graphs.capture", "toy.solve"), ("graphs.read", "toy.solve"),
        ("graphs.read", "toy.solve"), ("graphs.read", "toy.solve"),
        ("toy.solve", None)]
    assert stub.CAPTURES == 1 and stub.REPLAYS == 2
    (_, _, c0, c1), = [s for s in rec["spans"] if s[0] == "graphs.capture"]
    assert times["warm_up"][1] <= c0
    assert c0 <= times["capture"][0] and times["capture"][1] <= c1
    after = profiling.span_stats()["graphs.capture"]
    assert after["count"] == before["count"] + 1


def test_same_key_reuses_the_entry_and_its_graphs(stub):
    _solve(2)
    _solve(3)
    assert len(stub._CACHE) == 1 and (stub.CAPTURES, stub.REPLAYS) == (1, 4)
    _solve(2, n=4)                   # another chunk length: a second graph
    assert len(stub._CACHE) == 1 and stub.CAPTURES == 2
    entry = next(iter(stub._CACHE.values()))
    assert sorted(entry.graphs) == [(3,), (4,)]
    _solve(1, scale=2.0)             # another static value: another entry
    _solve(1, size=5)                # another shape: another entry
    _solve(1, name="other")          # another loop: another entry
    assert len(stub._CACHE) == 4 and stub.CAPTURES == 5
    keys = list(stub._CACHE)
    assert [k[0] for k in keys] == ["toy", "toy", "toy", "other"]
    assert keys[0][1] == (1.0,) and keys[1][1] == (2.0,)


def test_eviction_is_least_recently_used(stub, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 2)
    _solve(1, size=1)
    _solve(1, size=2)
    _solve(1, size=1)                # size 1 is now the most recent
    _solve(1, size=3)
    sizes = [key[2][0][1] for key in stub._CACHE]
    assert sizes == [(1,), (3,)]
    assert stub.cache_bytes() == (8 + 4) * 1 + (8 + 4) * 3


def test_over_budget_and_busy_solves_get_private_entries(stub, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_BYTES", 100)
    k = torch.zeros(64, dtype=torch.float64)           # 512 B + 256 B
    with graphs.Loop("big", {"k": k}, {"inc": torch.ones(64)},
                     (1.0,)) as lp:
        assert lp.state["k"] is k                       # nothing copied
        lp.run(_toy, 2)
        lp.run(_toy, 2)
    assert torch.equal(k, torch.full((64,), 4.0, dtype=torch.float64))
    assert not stub._CACHE and stub.REPLAYS == 1
    monkeypatch.setattr(graphs, "MAX_BYTES", 1 << 20)
    # A busy key's solve adds an entry only while there is room
    # (test_concurrent_waves_reuse_the_entries_of_their_key): here none.
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 1)
    outer = torch.zeros(4, dtype=torch.float64)
    with graphs.Loop("toy", {"k": outer}, {"inc": torch.ones(4)},
                     (1.0,)) as lp:
        lp.run(_toy, 1)
        inner = _solve(2, n=1)       # the same key while the entry is busy
        lp.run(_toy, 1)
    assert torch.equal(outer, torch.full((4,), 2.0, dtype=torch.float64))
    assert torch.equal(inner, torch.full((4,), 2.0, dtype=torch.float64))
    assert len(stub._CACHE) == 1 and not next(iter(
        stub._CACHE.values())).busy


def test_a_failed_capture_raises_and_counts_nothing(stub, monkeypatch):
    monkeypatch.setattr(_StubGraph, "fail", True)
    k = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="capture refused"):
        with graphs.Loop("toy", {"k": k}, {"inc": torch.ones(4)},
                         (1.0,)) as lp:
            lp.run(_toy, 3)
    # The warm-up chunk ran and counted; the failed capture did not.
    assert pivot_kernel.LAUNCHES == 6 and stub.CAPTURES == 0
    assert not next(iter(stub._CACHE.values())).busy


def test_stats_cache_bytes_and_clear(stub):
    _solve(2)
    _solve(1, size=8)
    recs = stub.stats()
    assert [r["graphs"] for r in recs] == [1, 1]
    assert [r["buffer_bytes"] for r in recs] == [4 * 8 + 4 * 4, 8 * 8 + 8 * 4]
    assert stub.cache_bytes() == 48 + 96
    stub.clear()
    assert stub.stats() == [] and stub.cache_bytes() == 0


def _failing_empty_like(monkeypatch, failures):
    """``torch.empty_like`` (the cache's allocation of an entry's buffers)
    raising the card's out-of-memory error on its first ``failures``
    calls."""
    empty_like = torch.empty_like
    calls = []

    def empty(*args, **kw):
        calls.append(1)
        if len(calls) <= failures:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return empty_like(*args, **kw)

    monkeypatch.setattr(torch, "empty_like", empty)
    return calls


def test_a_failed_allocation_drops_the_idle_entries_and_retries_once(
        stub, monkeypatch):
    _solve(1)                                   # an idle entry
    busy = torch.zeros(4, dtype=torch.float64)
    with graphs.Loop("busy", {"k": busy}, {"inc": torch.ones(4)},
                     (1.0,)) as lp:
        lp.run(_toy, 1)
        empty_like = torch.empty_like
        calls = _failing_empty_like(monkeypatch, 1)
        k = _solve(2, size=16)
        monkeypatch.setattr(torch, "empty_like", empty_like)
    assert len(calls) == 1 + 2                  # the failure, then k, inc
    assert torch.equal(k, torch.full((16,), 6.0, dtype=torch.float64))
    assert torch.equal(busy, torch.full((4,), 1.0, dtype=torch.float64))
    # The idle entry went; the busy one stayed.
    assert [(r["loop"], r["buffer_bytes"]) for r in stub.stats()] == [
        ("busy", 4 * 8 + 4 * 4), ("toy", 16 * 8 + 16 * 4)]


def test_a_second_failed_allocation_raises(stub, monkeypatch):
    _solve(1)
    _failing_empty_like(monkeypatch, 2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _solve(1, size=32)
    assert stub.stats() == []


def test_entries_on_a_destroyed_process_group_are_dropped(stub, tmp_path,
                                                          monkeypatch):
    """An entry whose static values hold a process group goes at the
    cache's next use once the group is destroyed: a subgroup, then the
    default group."""
    import torch.distributed as dist

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        sub = dist.new_group([0])
        for group in (sub, dist.group.WORLD):
            k = torch.zeros(4, dtype=torch.float64)
            with graphs.Loop("grouped", {"k": k}, {"inc": torch.ones(4)},
                             (1.0, group)) as lp:
                lp.run(_toy, 2)
            assert torch.equal(k, torch.full((4,), 2.0, dtype=torch.float64))
        _solve(1)
        assert [r["loop"] for r in stub.stats()] == ["grouped", "grouped",
                                                      "toy"]
        dist.destroy_process_group(sub)
        _solve(1)                         # _acquire and _release drop it
        assert [r["loop"] for r in stub.stats()] == ["grouped", "toy"]
        dist.destroy_process_group()
        _solve(1, size=8)
        assert [r["loop"] for r in stub.stats()] == ["toy", "toy"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _ReplayStub(_StubGraph):
    """A stub whose capture only records the chunk, for many threads."""

    def capture(self, fn):
        self.fn = fn
        return 0


def _threads(target, n, timeout=60):
    """Run ``target(i)`` on ``n`` threads with a short switch interval;
    returns the errors they raised."""
    import sys
    import threading

    errors = []

    def run(i):
        try:
            target(i)
        except Exception as exc:               # reported by the caller
            errors.append((i, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return errors


def _within_limits(stub, keys=2):
    """The cache holds entries of ``keys`` keys, within both limits, and
    none is in use."""
    entries = list(stub._CACHE.values())
    assert len({e.key for e in entries}) == keys
    assert len(entries) <= stub.MAX_ENTRIES
    assert stub.cache_bytes() <= stub.MAX_BYTES
    assert not any(e.busy for e in entries)


def test_concurrent_solves_keep_every_result_and_the_cache(stub,
                                                           monkeypatch):
    """Eight threads solving with two keys at once, with a short switch
    interval: a solve that finds every entry of its key in use adds one,
    every result is right, and the cache ends within its limits."""
    monkeypatch.setattr(graphs, "_new_graph", _ReplayStub)

    def worker(i):
        for chunks in range(1, 13):
            size = 2 + i % 2
            k = _solve(chunks, n=1, size=size)
            assert torch.equal(k, torch.full((size,), float(chunks),
                                             dtype=torch.float64)), (i, k)

    errors = _threads(worker, 8)
    assert not errors, errors[:3]
    _within_limits(stub)
    # At most one entry for each of a key's four threads.
    keys = [e.key for e in stub._CACHE.values()]
    assert max(keys.count(k) for k in keys) <= 4


class _ThreadStub(_StubGraph):
    """A stub that threads may use at once: its capture runs the chunk (to
    count what it enqueues) and puts the entry's state back."""

    def capture(self, fn):
        entry = next(cell.cell_contents for cell in fn.__closure__
                     if isinstance(cell.cell_contents, graphs._Entry))
        saved = {k: v.clone() for k, v in entry.state.items()}
        fn()
        for k, v in saved.items():
            entry.state[k].copy_(v)
        self.fn = fn
        return 0


def test_concurrent_waves_reuse_the_entries_of_their_key(stub, monkeypatch):
    """Two waves of eight threads on two keys, each thread holding its
    entry while all eight do: the first wave adds one entry a thread and
    captures each once; the second takes those entries and captures
    nothing.  No entry is handed out while in use, the cache stays within
    its limits, and every launch is counted once."""
    import threading

    monkeypatch.setattr(graphs, "_new_graph", _ThreadStub)
    held, lock, twice = set(), threading.Lock(), []
    acquire, release = graphs._acquire, graphs._release

    def acquiring(*args):
        entry = acquire(*args)
        with lock:
            if entry in held:
                twice.append(entry)
            held.add(entry)
        return entry

    def releasing(entry):
        with lock:
            held.discard(entry)
        release(entry)

    monkeypatch.setattr(graphs, "_acquire", acquiring)
    monkeypatch.setattr(graphs, "_release", releasing)

    def wave():
        barrier = threading.Barrier(8)

        def worker(i):
            size = 2 + i % 2
            k = torch.zeros(size, dtype=torch.float64)
            with graphs.Loop("toy", {"k": k}, {"inc": torch.ones(size)},
                             (1.0,)) as lp:
                barrier.wait(timeout=30)
                for _ in range(3):
                    lp.run(_toy, 2)
            assert torch.equal(k, torch.full((size,), 6.0,
                                             dtype=torch.float64)), (i, k)

        before = stub.CAPTURES, stub.REPLAYS
        errors = _threads(worker, 8)
        assert not errors, errors[:3]
        return stub.CAPTURES - before[0], stub.REPLAYS - before[1]

    assert wave() == (8, 16)
    slots = set(stub._CACHE)
    assert wave() == (0, 24)
    assert set(stub._CACHE) == slots and not twice
    _within_limits(stub)
    assert sorted(len(e.graphs) for e in stub._CACHE.values()) == [1] * 8
    # 2 waves x 8 threads x 3 chunks x 2 steps, 2 K1 and 1 K3 a step.
    assert pivot_kernel.LAUNCHES == 2 * 8 * 3 * 2 * 2
    assert batched_kernel.LAUNCHES_K3 == 2 * 8 * 3 * 2


class _NeighbourStub(_ThreadStub):
    """A capture during which another thread launches K1 five times before
    the chunk is captured and five times after."""

    def capture(self, fn):
        import threading

        def neighbour():
            counters.add(vars(pivot_kernel), "LAUNCHES", 5)

        out = None
        for step in range(2):
            t = threading.Thread(target=neighbour)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            if step == 0:
                out = super().capture(fn)
        return out


def test_a_capture_counts_only_its_own_threads_launches(stub, monkeypatch):
    """Another thread's launches during a capture stay counted, and the
    graph records its own chunk's launches only."""
    monkeypatch.setattr(graphs, "_new_graph", _NeighbourStub)
    k = _solve(3, n=2)                  # warm-up and capture, 2 replays
    assert torch.equal(k, torch.full((4,), 6.0, dtype=torch.float64))
    assert pivot_kernel.LAUNCHES == 3 * 2 * 2 + 10
    assert batched_kernel.LAUNCHES_K3 == 3 * 2
    (graph, outside, steps), = next(iter(stub._CACHE.values())).graphs.values()
    assert outside == [2 * 2, 0, 2, 0] and steps == []


def test_counters_lose_no_update_under_threads(monkeypatch):
    """Eight threads adding to one counter at once: the counter holds every
    addition, and each thread's tally its own."""
    monkeypatch.setattr(pivot_kernel, "LAUNCHES", 0)
    tallies = {}

    def worker(i):
        before = counters.mine(vars(pivot_kernel), "LAUNCHES")
        for _ in range(5000):
            counters.add(vars(pivot_kernel), "LAUNCHES", i + 1)
        tallies[i] = counters.mine(vars(pivot_kernel), "LAUNCHES") - before

    assert not _threads(worker, 8)
    assert pivot_kernel.LAUNCHES == 5000 * sum(range(1, 9))
    assert tallies == {i: 5000 * (i + 1) for i in range(8)}


def test_capture_streams_come_from_outside_torchs_pool(monkeypatch):
    """Eight threads that warm up or capture at once each hold a stream no
    other holds; a stream given back is taken again before one more is
    made, per device; none is drawn from torch's pool of streams, which
    every other caller draws from too."""
    import threading

    made = []

    class Side:
        def __init__(self, device):
            self.device = device
            made.append(self)

    def pool(*args, **kwargs):
        raise AssertionError("a capture stream drawn from torch's pool")

    monkeypatch.setattr(graphs, "_new_side", Side)
    monkeypatch.setattr(graphs, "_SIDE_IDLE", collections.defaultdict(list))
    monkeypatch.setattr(torch.cuda, "Stream", pool)
    held, barrier = {}, threading.Barrier(8)

    def worker(i):
        held[i] = graphs._take_side("cuda:0")
        barrier.wait(timeout=30)            # all eight held at once
        graphs._give_side("cuda:0", held[i])

    assert not _threads(worker, 8)
    assert len({id(s) for s in held.values()}) == 8 == len(made)
    again = [graphs._take_side("cuda:0") for _ in range(8)]
    assert {id(s) for s in again} == {id(s) for s in made}
    assert graphs._take_side("cuda:0") not in made[:8] and len(made) == 9
    for side in again:
        graphs._give_side("cuda:0", side)
    other = graphs._take_side("cuda:1")
    assert other.device == "cuda:1" and len(made) == 10


def test_cpu_tensors_and_the_eager_switch_run_the_body(monkeypatch):
    monkeypatch.setattr(graphs, "_CACHE", collections.OrderedDict())
    before = graphs.EAGER_CHUNKS, graphs.REPLAYS
    k = _solve(3)
    assert torch.equal(k, torch.full((4,), 9.0, dtype=torch.float64))
    assert graphs.EAGER_CHUNKS - before[0] == 3
    assert graphs.REPLAYS == before[1] and not graphs._CACHE
    assert graphs._graphed(torch.device("cuda")) is True
    monkeypatch.setattr(graphs, "_EAGER", True)
    assert graphs._graphed(torch.device("cuda")) is False
    assert graphs._graphed(torch.device("cpu")) is False


def test_stream_uploads_each_batch_after_the_previous_first_chunk(
        monkeypatch):
    """Batch k+1's upload is issued once, between batch k's first and
    second chunk; the first batch's before its own solve."""
    events = []
    chunk, upload, run = tb._batch_chunk, staging.Staged.upload, \
        tmb._run_batch

    def chunk_(*a):
        events.append("chunk")
        return chunk(*a)

    def upload_(self):
        if self._host:
            events.append("upload")
        return upload(self)

    def run_(*a, **kw):
        events.append("batch")
        return run(*a, **kw)

    monkeypatch.setattr(tb, "_batch_chunk", chunk_)
    monkeypatch.setattr(staging.Staged, "upload", upload_)
    monkeypatch.setattr(tmb, "_run_batch", run_)
    batches = [random_batch(s, B=6, ops=MIXED_OPS) for s in (21, 22, 23)]
    cfg = SolverConfig(device=CPU, refactor_every=4)
    outs = list(tmb.solve_arrays_stream(iter(batches), cfg))
    assert len(outs) == 3 and all(np.all(o.certified) for o in outs)
    per_batch = " ".join(events).split("batch")
    assert per_batch[0].split() == ["upload"]
    for k, seq in enumerate(per_batch[1:]):
        seq = seq.split()
        assert seq.count("chunk") >= 2
        if k < 2:
            assert seq[:2] == ["chunk", "upload"]
            assert seq.count("upload") == 1
        else:
            assert "upload" not in seq
    for res, batch in zip(outs, batches):
        ref = tmb.BatchedSimplexSolver(cfg).solve_arrays(*batch,
                                                         maximize=True)
        np.testing.assert_array_equal(res.status, ref.status)
        np.testing.assert_array_equal(res.x, ref.x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_solve_is_bit_equal_to_the_eager_solve(cuda, case, dtype,
                                                     monkeypatch):
    """Eager, then graphs twice (the first run captures every chunk
    variant after running it, the second replays them): the same outputs,
    bit for bit, and the same kernel launches."""
    runs = []
    for eager in (True, False, False):
        monkeypatch.setattr(graphs, "_EAGER", eager)
        counts, replays = graphs._read_counters(), graphs.REPLAYS
        out = CASES[case](cuda, dtype)
        torch.cuda.synchronize()
        runs.append((out, [b - a for a, b in
                           zip(counts, graphs._read_counters())],
                     graphs.REPLAYS - replays))
    (eager_out, eager_n, r0), (_, _, r1), (out, n, r2) = runs
    assert r0 == 0 and r2 > 0
    assert n == eager_n
    for got, _, _ in runs[1:]:
        assert sorted(got) == sorted(eager_out)
        for k in eager_out:
            np.testing.assert_array_equal(got[k], eager_out[k], err_msg=k)
    graphs.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["dense_phase", "dense_phase_dantzig",
                                  "dual", "dual_bounded", "batched_le",
                                  "batched_mixed", "bounded_le",
                                  "bounded_mixed", "revised", "sharded",
                                  "sharded_classic"])
def test_replayed_chunks_stop_at_the_verdict(cuda, case, dtype,
                                             monkeypatch):
    """Through replayed graphs (the first run captures, the second
    replays every chunk): K1 once a pivot plus once a chunk in the dense
    and dual loops (the artificials' eviction apart), K2 or K3 once an
    iteration in the batched loops, the revised loop's iterations plus at
    most one step a chunk, the one-rank sharded loop one step an
    iteration and no kernel of the port."""
    evicted = []
    evict = tt._evict_artificials

    def counted(*args, **kw):
        before = pivot_kernel.LAUNCHES
        out = evict(*args, **kw)
        evicted.append(pivot_kernel.LAUNCHES - before)
        return out

    monkeypatch.setattr(tt, "_evict_artificials", counted)
    # The dual cases' inputs come from CPU solves: build them first.
    for name in ("dual_inputs", "dual_bounded_inputs"):
        made = getattr(loop_cases, name)()
        monkeypatch.setattr(loop_cases, name, lambda *a, made=made: made)
    for _ in range(2):
        evicted.clear()
        counts, steps0 = graphs._read_counters(), graphs.STEPS
        reads, replays = tt.STATE_READS + t_rev.STATE_READS, graphs.REPLAYS
        out = CASES[case](cuda, dtype)
        torch.cuda.synchronize()
        k1, k2, k3 = [b - a for a, b in
                      zip(counts, graphs._read_counters())][:3]
        steps = graphs.STEPS - steps0
        chunks = tt.STATE_READS + t_rev.STATE_READS - reads
    assert graphs.REPLAYS > replays
    if case == "revised":
        iters = int(out["iters1"])          # phase 1's iterations included
        assert iters < steps <= iters + chunks and k1 == k2 == k3 == 0
    elif case.startswith(("dense", "dual")):
        iters = int(out["iters"])
        assert k1 - sum(evicted) == steps == iters + chunks
    elif case.startswith("sharded"):
        iters = int(out["iters"])
        assert steps == iters > 0 and k1 == k2 == k3 == 0
    else:
        iters = int(out["iters"])
        assert steps == iters > 0 and k1 == 0
        assert (k2, k3) == ((0, iters) if case.startswith("bounded")
                            else (iters, 0))
    graphs.clear()
