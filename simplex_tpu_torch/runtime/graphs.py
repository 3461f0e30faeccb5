"""One CUDA graph a chunk of a solve loop, replayed.

This is the port's counterpart of the JAX package's compiled
``lax.while_loop``.  Every solve loop of the port runs in chunks of device
steps with one host read of its state between two chunks
(``ops/tableau.py``, ``ops/batched.py``, ``models/revised.py``,
``models/pdhg.py``, ``parallel/sharded.py``).  Each loop writes its chunk
once, as a function of its state tensors (the chunk body), and runs it
through a :class:`Loop`:

* on a CPU tensor, the body runs eagerly: that is the device the caller
  chose, and the tests run that way;
* on a CUDA tensor, the chunk is one captured CUDA graph, replayed.  The
  graph is made the first time its cache key is met: the body runs once
  eagerly on a side stream as that chunk's real work (it builds and loads
  the kernels, gives cuBLAS and cuSOLVER their workspaces and makes NCCL's
  communicator exist, so nothing is first done inside the capture), then it
  is captured.  A capture or replay that fails raises; nothing falls back
  to the eager chunk.  The private switch ``_EAGER`` runs the eager chunk
  on the card, for the checks that hold the two bit-equal; no entry point
  reads it.

The graph path keeps each cache entry's own static buffers: the loop state
(the tensors the chunks update) and the read-only inputs the body reads.
A solve copies both in once, replays the entry's graphs, takes its
decisions between two replays by writing into the same buffers in place,
and at the end copies the state back out into its own tensors.  A graph
ends with in-place copies of the new state into the buffers, so replay
k+1 reads what replay k wrote.  The arithmetic, the kernels and the order
of the launches are those of the eager chunk, so a graph solve is
bit-equal to an eager one.

The cache key is the loop's name, the shapes, strides and dtypes of every
buffer, the device, and the Python values the body reads (the ``static``
tuple: tolerances, caps, flags, the backend, a process group); within an
entry, each chunk variant (its length, and what else the loop passes to
``run``) is one graph.  The graphs of one entry share one memory pool
(they never run at the same time, and every value they leave behind is in
the static buffers).  The cache holds at most :data:`MAX_ENTRIES` entries
and :data:`MAX_BYTES` bytes of buffers and pools on the card; the least
recently used idle entries go first.  Several entries may stand under one
key, as a compiled executable serves several threads at once: a solve
takes an idle entry of its key, and where every one is in use (other
threads are solving the same shapes) it adds one more while the entries
in use leave room within both limits.  An entry is never in use by two
solves.  A solve for which there is no room, or whose buffers alone
exceed the budget, runs on a private entry whose buffers are its own
tensors (nothing is copied) and which is dropped when the solve ends.
Where a new entry's buffers do not fit on the card, the idle entries are
dropped and the allocation is tried once more.  An idle entry whose
``static`` holds a process group that ``torch.distributed`` no longer knows
(destroyed) is dropped when the cache is next used, so no graph outlives
the group whose collectives it captured.  One capture runs at a time in
the process; replays and eager chunks of other solves run beside it.

Loop exit (the reference's ``lax.while_loop`` condition): a chunk body
runs its steps through :func:`steps`.  Every step writes its new state
into the state tensors in place, raises ``state["steps"]`` and sets
``state["go"]``, a 0-d bool, to whether the next step may change
anything; no step runs once ``go`` is false.  Eagerly the host reads
``go`` before each step after the first (a free read on the CPU).  A
capture holds the first step and one more: the chunk is captured as an
ordered list of parts, each a torch CUDA graph in the entry's pool (the
stretches outside any step, the first step, the second), and
``csrc/graph_steps.cu`` chains them into one executable graph in which
the second step is the body of a WHILE conditional node (CUDA >= 12.4)
that runs while ``go`` holds and the chunk has steps left (through the
CUDA runtime: PyTorch 2.11, on the card, binds no conditional capture of
its own).  A replay then launches no kernel after the step that reached
the verdict, and the host reads nothing more than before.  Every step
after a chunk's first runs the same code, as a ``while_loop``'s body does.

Launch counts: a capture enqueues kernels without running them, so the
wrappers' counters (``LAUNCHES`` of K1, K2, K3 and K4) are set back after
it, by the launches its own thread enqueued during it (``counters.mine``:
another thread's launches meanwhile are real and stay counted).  A replay
adds the launches its capture enqueued outside any step at once, and
those of the steps that ran when the loop reads the state
(:meth:`Loop.read`, which reads ``state["steps"]`` with the loop's own
values, in the same transfer): the first step's, then the second's for
every later one.
"""
from __future__ import annotations

import collections
import ctypes
import itertools
import threading
import warnings
from typing import Callable, Dict, List, Optional

import torch

from ..utils.profiling import trace_span
from . import counters

# The most entries, and the most bytes of static buffers and graph pools on
# the card, that the cache keeps between solves.
MAX_ENTRIES = 8
MAX_BYTES = 4 << 30

# Private: True runs every chunk eagerly on the card (the checks of
# graph against eager set it; no entry point and no environment variable
# reads it).
_EAGER = False

# Chunks run since the counters were last reset to 0: replays of a graph,
# captures (each after its chunk ran eagerly as the warm-up), and eager
# chunks (on the CPU, under _EAGER, and the warm-ups); and steps.
REPLAYS = 0
CAPTURES = 0
EAGER_CHUNKS = 0
# Steps of bodies with steps that ran (counted at each Loop.read).
STEPS = 0

# Each entry under its slot (its key and a serial number), least recently
# used first.
_CACHE: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_LOCK = threading.Lock()
_SERIAL = itertools.count()
# One capture at a time in the process (replays and eager chunks run on):
# after a torch.profiler session, captures on several threads at once hang
# in CUDA on the card (ROADMAP.md, Queue 3).
_CAPTURE_LOCK = threading.Lock()


def _counters():
    """The kernel wrappers' launch counters, as (module, name) pairs."""
    from ..ops import batched_kernel, pivot_kernel, stream_kernel

    return ((pivot_kernel, "LAUNCHES"), (batched_kernel, "LAUNCHES"),
            (batched_kernel, "LAUNCHES_K3"), (stream_kernel, "LAUNCHES"))


def _read_counters():
    return [getattr(mod, name) for mod, name in _counters()]


def _own_counters():
    """The launches this thread has counted, counter by counter."""
    return [counters.mine(vars(mod), name) for mod, name in _counters()]


def _add_counters(counts):
    for (mod, name), n in zip(_counters(), counts):
        counters.add(vars(mod), name, n)


def _store(state: Dict[str, torch.Tensor],
           new: Optional[Dict[str, torch.Tensor]]):
    """Write a chunk's or a step's new values into the state tensors, in
    place (``new`` None: the body wrote them itself)."""
    for k, v in (new or {}).items():
        if v is not state[k]:
            state[k].copy_(v)


def store(state: Dict[str, torch.Tensor], **new: torch.Tensor):
    """End a step: copy its new values into the state tensors (``copy_``
    is exact, so a step reads what the previous one computed, bit for
    bit)."""
    _store(state, new)


# The capture under way on this thread, if any (read by steps()).
_CAPTURING = threading.local()


class _Record:
    """What one capture enqueued: the launches of each step it holds (the
    first step and the loop's body)."""

    def __init__(self, graph):
        self.graph = graph
        self.steps: List[List[int]] = []


def step_state(device) -> Dict[str, torch.Tensor]:
    """The two state tensors of a loop whose body runs :func:`steps`."""
    return {"go": torch.ones((), dtype=torch.bool, device=device),
            "steps": torch.zeros((), dtype=torch.int64, device=device)}


def steps(state: Dict[str, torch.Tensor], n_steps: int):
    """The steps of one chunk: ``for _ in steps(state, n): <one step>``.

    Yields at most ``n_steps`` times.  The first step always runs; each
    later one only while ``state["go"]`` (0-d bool, written by the step
    before it) is true, so a step must leave ``go`` false only where
    every later step of the chunk would change no state tensor.  Every
    step after the first must run the same code.  ``state["steps"]``
    (0-d int64) counts the steps that ran.  Eagerly, the host reads ``go``
    before each later step and stops at the first false one.  A capture
    takes the first step, then the second as the body of a WHILE node on
    ``go`` and the count (:class:`_CudaGraph`), and stops.
    """
    go, count = state["go"], state["steps"]
    rec = getattr(_CAPTURING, "rec", None)
    count.zero_()
    for k in range(n_steps if rec is None else min(n_steps, 2)):
        if rec is None:
            if k and not bool(go):
                return
            count.add_(1)
            yield k
            continue
        rec.graph.begin_step((go, count, n_steps) if k else None)
        before = _own_counters()
        try:
            count.add_(1)
            yield k
        finally:
            rec.steps.append([b - a for a, b in
                              zip(before, _own_counters())])
            rec.graph.end_step()


class _CudaGraph:
    """One captured chunk on the card: its warm-up, its capture into the
    entry's memory pool and its replay.

    A chunk without steps is one torch graph.  A chunk with steps is
    captured as parts (``begin_step`` / ``end_step`` cut them), chained by
    ``csrc/graph_steps.cu`` into one executable graph in which the second
    step's part is the body of a WHILE node."""

    def __init__(self, device, pool):
        self.device = device
        self.pool = pool
        self.graph = None
        # (torch graph, loop or None) of each part, in capture order; the
        # parts hold the pool (and so the memory the chain addresses).
        self._parts = []
        self._open = None
        self._exec = None
        self._lib = None
        self._stream = None
        self._side = None

    def warm_up(self, fn: Callable[[], None]):
        """Run ``fn`` eagerly on the side stream that will capture it,
        ordered after the current stream's work and before its next (so
        cuBLAS's workspace for that stream exists before the capture).  The
        stream is this graph's until :meth:`capture` ends."""
        current = torch.cuda.current_stream(self.device)
        side = self._side = _take_side(self.device)
        try:
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn()
            current.wait_stream(side)
        except BaseException:
            self._side = None
            _give_side(self.device, side)
            raise

    def capture(self, fn: Callable[[], None]) -> int:
        """Capture ``fn`` (it does not run) on the warm-up's side stream.
        Returns the bytes the capture added to the allocator's reserve (the
        pool's growth)."""
        current = torch.cuda.current_stream(self.device)
        before = torch.cuda.memory_reserved(self.device)
        side, self._side = self._side, None
        try:
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._begin(None)
                try:
                    fn()
                finally:
                    self._end()
                if len(self._parts) == 1:
                    self.graph = self._parts.pop()[0]
                    self.graph.instantiate()
                else:
                    self._chain(side)
            current.wait_stream(side)
        finally:
            _give_side(self.device, side)
        return torch.cuda.memory_reserved(self.device) - before

    def begin_step(self, loop):
        """Start a step's part: ``loop`` None for one that runs once, or
        ``(go, count, n_steps)`` for the body of a WHILE node that runs
        while ``go`` holds and ``count < n_steps``."""
        self._end()
        self._begin(loop)

    def end_step(self):
        self._end()
        self._begin(None)

    def _begin(self, loop):
        # thread_local: another thread's allocations (the certify worker,
        # a server thread) do not break this capture.  keep_graph: the
        # chain clones the part's graph.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = (graph, loop)

    def _end(self):
        graph, loop = self._open
        self._open = None
        with warnings.catch_warnings():
            # The part after a step is empty; the chain leaves it out.
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        self._parts.append((graph, loop))

    def _chain(self, stream):
        from . import kernels

        lib = kernels.library()
        n = len(self._parts)
        loops = [loop or (None, None, 0) for _, loop in self._parts]

        def ptrs(i):
            return (ctypes.c_uint64 * n)(*(0 if lp[i] is None
                                           else lp[i].data_ptr()
                                           for lp in loops))

        parts = (ctypes.c_uint64 * n)(
            *(g.raw_cuda_graph() for g, _ in self._parts))
        limits = (ctypes.c_int64 * n)(*(lp[2] for lp in loops))
        exec_ = ctypes.c_void_p()
        err = lib.graph_chain_build(n, parts, ptrs(0), ptrs(1), limits,
                                    ctypes.byref(exec_), stream.cuda_stream)
        if err != 0:
            raise RuntimeError("building a chunk's graph with its loop of "
                               f"steps failed: CUDA error {err}")
        self._lib, self._exec = lib, exec_

    def replay(self):
        if self._exec is None:
            self.graph.replay()
            return
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.graph_chain_launch(self._exec, self._stream)
        if err != 0:
            raise RuntimeError(f"a chunk's graph failed to launch: CUDA "
                               f"error {err}")

    def __del__(self):
        # After the last launch has finished; the parts (and the pool they
        # hold) go after the chain.
        if self._exec is not None:
            self._lib.graph_chain_destroy(self._exec, self._stream)


# The idle side streams of each device, made for warm-ups and captures.
_SIDE_IDLE: Dict[str, list] = collections.defaultdict(list)
_SIDE_LOCK = threading.Lock()


def _take_side(device) -> "torch.cuda.Stream":
    """A side stream for one chunk's warm-up and capture, as
    ``torch.cuda.graph`` keeps one capture stream, that nothing else holds:
    work that another thread enqueued on a capturing stream would join the
    capture.  torch hands out its own streams round-robin from a pool of
    32 a device, to any caller (``solve_arrays_stream``'s uploads, a
    library user), so these streams are made outside it
    (:func:`_new_side`); an idle one is taken again, else one more is
    made."""
    with _SIDE_LOCK:
        idle = _SIDE_IDLE[str(device)]
        if idle:
            return idle.pop()
    return _new_side(device)


def _new_side(device) -> "torch.cuda.Stream":
    """A new stream of the device's own (``graph_stream_create``: it does
    not wait for the legacy default stream), kept for the process's
    life."""
    from . import kernels

    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        err = kernels.library().graph_stream_create(ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(f"making a capture stream failed: CUDA error "
                           f"{err}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def _give_side(device, stream):
    with _SIDE_LOCK:
        _SIDE_IDLE[str(device)].append(stream)


def _new_graph(device, pool):
    """The graph object of one chunk variant (a stub in the CPU tests)."""
    return _CudaGraph(device, pool)


def _new_pool(device):
    """The memory pool the graphs of one entry share."""
    with torch.cuda.device(device):
        return torch.cuda.graph_pool_handle()


def _nbytes(tensors: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _signature(tensors: Dict[str, torch.Tensor]):
    return tuple((k, tuple(v.shape), tuple(v.stride()), v.dtype)
                 for k, v in sorted(tensors.items()))


class _Entry:
    """One loop at one set of shapes, dtypes and static values: the static
    buffers, the shared pool and one graph a chunk variant."""

    def __init__(self, key, state, consts, device, private=False):
        self.key = key
        self.slot = key + (next(_SERIAL),)
        self.device = device
        self.private = private
        if private:
            # Serves one solve and is dropped: its buffers are the solve's
            # own tensors, with nothing to copy in or out.
            self.state, self.consts = dict(state), dict(consts)
        else:
            # empty_like keeps each tensor's strides, so the body sees the
            # layout the eager solve has.
            self.state = {k: torch.empty_like(v) for k, v in state.items()}
            self.consts = {k: torch.empty_like(v) for k, v in consts.items()}
        self.buffer_bytes = _nbytes(state) + _nbytes(consts)
        self.pool_bytes = 0
        self.pool = None
        self.graphs = {}            # variant -> (graph, launches a replay)
        self.busy = False

    @property
    def nbytes(self) -> int:
        return self.buffer_bytes + self.pool_bytes

    def load(self, state, consts):
        for mine, theirs in ((self.state, state), (self.consts, consts)):
            for k, v in theirs.items():
                mine[k].copy_(v)

    def run(self, body, static, args):
        """One chunk: a replay, or the warm-up and capture of a new
        variant (the capture, with its wait for another thread's, is the
        span ``graphs.capture``; the warm-up is not).  Returns the launches of
        each step of a replay, which the loop adds once it knows how many
        ran (:meth:`Loop.read`)."""
        hit = self.graphs.get(args)
        if hit is not None:
            graph, launches, step_launches = hit
            graph.replay()
            _add_counters(launches)
            counters.add(globals(), "REPLAYS")
            return step_launches

        def chunk():
            _store(self.state, body(self.state, self.consts, static, *args))

        if self.pool is None:
            self.pool = _new_pool(self.device)
        graph = _new_graph(self.device, self.pool)
        # The warm-up is this chunk's real work, eager and counted (and, in
        # a new process, where its kernels are first built or loaded).
        graph.warm_up(chunk)
        counters.add(globals(), "EAGER_CHUNKS")
        before = _own_counters()
        rec = _CAPTURING.rec = _Record(graph)
        try:
            with trace_span("graphs.capture"), _CAPTURE_LOCK:
                self.pool_bytes += max(graph.capture(chunk), 0)
        finally:
            _CAPTURING.rec = None
            # What this thread enqueued: the capture ran none of it, so it
            # is set back.
            enqueued = [b - a for a, b in zip(before, _own_counters())]
            _add_counters([-n for n in enqueued])
        # The launches outside any step, and those of each step.
        outside = [n - sum(s[i] for s in rec.steps)
                   for i, n in enumerate(enqueued)]
        self.graphs[args] = (graph, outside, rec.steps)
        counters.add(globals(), "CAPTURES")
        return None


def _group_gone(value) -> bool:
    """Whether ``value`` is a process group that ``torch.distributed`` no
    longer knows (it was destroyed)."""
    import torch.distributed as dist

    if not (dist.is_available() and isinstance(value, dist.ProcessGroup)):
        return False
    try:
        dist.get_process_group_ranks(value)
    except (KeyError, RuntimeError, ValueError):
        return True
    return False


def _drop(keep: Callable[[_Entry], bool]) -> List[_Entry]:
    """Take every idle entry that ``keep`` refuses out of the cache, and
    return them: the caller lets them go after it has left the lock (a
    chained graph's destruction waits for its last launch)."""
    gone = [e for e in _CACHE.values() if not e.busy and not keep(e)]
    for e in gone:
        del _CACHE[e.slot]
    return gone


def _drop_stale() -> List[_Entry]:
    """Drop the idle entries whose static values hold a destroyed process
    group (the key's second item is the loop's ``static``)."""
    return _drop(lambda e: not any(_group_gone(v) for v in e.key[1]))


def _new_entry(key, state, consts, device) -> _Entry:
    """A cache entry with buffers of its own; where they do not fit on the
    card, the idle entries are dropped and the allocation tried once
    more."""
    try:
        return _Entry(key, state, consts, device)
    except torch.cuda.OutOfMemoryError:
        _drop(lambda e: False)
        return _Entry(key, state, consts, device)


def _room(nbytes: int) -> bool:
    """Whether a new entry with ``nbytes`` of buffers may join the cache:
    with the entries in use it stays within both limits (the idle ones go
    at the next release)."""
    busy = [e for e in _CACHE.values() if e.busy]
    return (len(busy) < MAX_ENTRIES
            and sum(e.nbytes for e in busy) + nbytes <= MAX_BYTES)


def _acquire(key, state, consts, device) -> _Entry:
    """An idle cache entry of ``key``, or a new one where every entry of
    the key is in use and there is room, else a private entry; marked
    busy and filled with the solve's tensors."""
    with _LOCK:
        gone = _drop_stale()
        entry = next((e for e in _CACHE.values()
                      if e.key == key and not e.busy), None)
        if entry is not None:
            _CACHE.move_to_end(entry.slot)
        elif _room(_nbytes(state) + _nbytes(consts)):
            entry = _new_entry(key, state, consts, device)
            _CACHE[entry.slot] = entry
        else:
            entry = _Entry(key, state, consts, device, private=True)
        entry.busy = True
    del gone
    if not entry.private:
        entry.load(state, consts)
    return entry


def _release(entry: _Entry):
    with _LOCK:
        entry.busy = False
        gone = _drop_stale() + _evict()
    del gone


def _evict() -> List[_Entry]:
    """Drop the least recently used idle entries until the cache holds at
    most MAX_ENTRIES entries and MAX_BYTES bytes; returns them."""
    gone = _drop(lambda e: e.nbytes <= MAX_BYTES)

    def over():
        return (len(_CACHE) > MAX_ENTRIES
                or sum(e.nbytes for e in _CACHE.values()) > MAX_BYTES)

    for e in list(_CACHE.values()):
        if not over():
            break
        if not e.busy:
            del _CACHE[e.slot]
            gone.append(e)
    return gone


def clear():
    """Drop every idle cache entry."""
    with _LOCK:
        gone = _drop(lambda e: False)
    del gone


def stats():
    """One record a cache entry: its loop, its graphs, the bytes it holds
    on the card (buffers and pool) and whether a solve is using it.  The
    seconds of the captures are the span ``graphs.capture``'s totals
    (``utils/profiling.py::span_stats``)."""
    with _LOCK:
        return [{"loop": e.key[0], "graphs": len(e.graphs),
                 "buffer_bytes": e.buffer_bytes,
                 "pool_bytes": e.pool_bytes, "busy": e.busy}
                for e in _CACHE.values()]


# cudaGraphNodeType's names, in its order.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semaphore_signal",
              "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def node_types(raw_graph: int) -> Dict[str, int]:
    """The nodes of a captured ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``
    of a graph captured with ``keep_graph=True``) counted by type, those of
    its child graphs included; types it does not hold are left out."""
    from . import kernels

    counts = (ctypes.c_int64 * (len(NODE_TYPES) + 2))()
    err = kernels.library().graph_node_counts(raw_graph, len(counts), counts)
    if err != 0:
        raise RuntimeError(f"reading a graph's nodes failed: CUDA error {err}")
    names = NODE_TYPES + tuple(f"type_{t}" for t in range(len(NODE_TYPES),
                                                           len(counts)))
    return {name: int(n) for name, n in zip(names, counts) if n}


def captured_parts(name: str) -> list:
    """What each captured chunk of the cached entries of loop ``name``
    holds: one ``(variant, parts)`` a chunk variant, ``parts`` a list of
    ``(kind, node_types)`` in capture order, ``kind`` ``"once"`` or
    ``"while"`` (the body of the WHILE node).  Empty on the CPU."""
    with _LOCK:
        entries = [e for e in _CACHE.values() if e.key[0] == name]
    out = []
    for entry in entries:
        for variant, (graph, _, _) in entry.graphs.items():
            parts = ([(graph.graph, None)] if graph.graph is not None
                     else graph._parts)
            out.append((variant, [
                ("once" if loop is None else "while",
                 node_types(g.raw_cuda_graph())) for g, loop in parts]))
    return out


def cache_bytes() -> int:
    """The bytes the cache holds on the card."""
    with _LOCK:
        return sum(e.nbytes for e in _CACHE.values())


def _graphed(device: torch.device) -> bool:
    return device.type == "cuda" and not _EAGER


class Loop:
    """One solve loop's state, run a chunk at a time.

    ``name`` names the loop; ``state`` its tensors that the chunks update
    (the loop takes them over: at the end they hold the final state; a
    body with steps needs :func:`step_state`'s two); ``consts`` the read-only
    tensors the body reads; ``static`` a hashable tuple of the Python
    values the body reads.  Use as a context manager::

        with Loop("tableau.phase", state, consts, static) as lp:
            lp.run(body, n_steps)       # one chunk
            a, b = lp.read(x, y)        # the host's read after it
            lp.state["T"]               # the state between two chunks

    ``body(state, consts, static, *args)`` either returns the new values
    of some state keys or writes them in place and returns None (a body
    that runs :func:`steps` does the latter); it must not read the host's
    clock, the device's results or any Python value that is not in
    ``static`` or ``args``.  ``args`` (hashable) select the chunk variant,
    such as its length.  Between two chunks the caller reads and writes
    ``lp.state`` in place only, and a body with steps has its chunk's
    state read through :meth:`read` before the next chunk.
    """

    def __init__(self, name: str, state: Dict[str, torch.Tensor],
                 consts: Dict[str, torch.Tensor], static: tuple = ()):
        self.name = name
        self.static = static
        first = next(iter(state.values()))
        self.device = first.device
        self._own = state
        self._consts = consts
        self._entry: Optional[_Entry] = None
        self._pending = None
        self.state = state
        self.consts = consts

    def __enter__(self) -> "Loop":
        if _graphed(self.device):
            key = (self.name, self.static, _signature(self._own),
                   _signature(self._consts), str(self.device))
            self._entry = _acquire(key, self._own, self._consts, self.device)
            self.state = self._entry.state
            self.consts = self._entry.consts
        return self

    def run(self, body, *args):
        """One chunk of the loop."""
        if self._pending:
            raise RuntimeError(f"{self.name}: read the last chunk's state "
                               "(Loop.read) before the next chunk")
        if self._entry is not None:
            self._pending = self._entry.run(body, self.static, args)
            return
        _store(self.state, body(self.state, self.consts, self.static, *args))
        counters.add(globals(), "EAGER_CHUNKS")

    def read(self, *vals: torch.Tensor, dtype=torch.int64) -> list:
        """The host's one read after a chunk: ``vals`` (0-d tensors) as
        Python numbers through ``dtype``, read in one transfer with the
        chunk's step count, which adds the launches of the steps that a
        replay ran to the kernels' counters.  The transfer, where the host
        waits for the card, is the span ``graphs.read``."""
        with trace_span("graphs.read"):
            out = torch.stack([v.to(dtype) for v in
                               (*vals, self.state["steps"])]).tolist()
        pending, self._pending = self._pending, None
        ran = int(out.pop())
        counters.add(globals(), "STEPS", ran)
        if pending:
            # The first step's launches, then the loop body's for each
            # later step.
            _add_counters([pending[0][i] + (ran - 1) * pending[-1][i]
                           for i in range(len(pending[0]))])
        return out

    def __exit__(self, exc_type, *exc):
        entry, self._entry = self._entry, None
        self._pending = None
        if entry is None:
            return False
        try:
            if exc_type is None:
                _store(self._own, entry.state)
        finally:
            self.state, self.consts = self._own, self._consts
            _release(entry)
        return False
