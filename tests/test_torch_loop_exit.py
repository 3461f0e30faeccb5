"""The solve loops stop at the verdict, as the reference's ``while_loop``s.

Each loop's chunk runs its steps through ``runtime/graphs.py::steps``: a
step after a chunk's first runs only while the step before it left
``go`` true.  Eagerly the host reads ``go``; in a captured chunk those
steps are the body of a WHILE conditional node on ``go``.  On the CPU,
for each loop that uses it, in float64:

* a stub graph that honours the steps (a capture records the first step
  and the loop's body under ``go`` and runs nothing; a replay reads
  ``go`` on the host) gives the loop's recorded results (``GOLDEN``) and
  the eager solve's launches;
* the steps that run, held to the JAX package on the same inputs: the
  ``phase2_only`` batched loops launch K2 / K3 once for each of JAX's
  ``iters``; the dense and dual loops launch K1 once a pivot plus once a
  chunk; the revised loop runs its iterations plus the verdict step of
  each phase;
* a step entered with ``go`` false leaves every state tensor bit-equal.

The row-sharded loop (on the 1x1 mesh, without a process group) runs its
steps the same way: through the stub its results are the eager ones, and
it runs one step for each of the JAX ``solve_tableau_sharded``'s
iterations on the same float64 inputs.

The kernel wrappers count nothing on a CPU tensor, so the wrappers the
loops call are wrapped here to count each call as a launch.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_cases as lc
from _torch_parity import CPU
from test_torch_graphs import GOLDEN
from test_torch_sharded import SINGLE, _compiled, _jax_tableau, _step_equal

import simplex_tpu.models.revised as j_rev
from simplex_tpu.ops import batched as jb
from simplex_tpu.ops import tableau as jt
from simplex_tpu_torch.core.problem import STATUS_OPTIMAL, STATUS_UNBOUNDED
from simplex_tpu_torch.models import revised as t_rev
from simplex_tpu_torch.ops import batched as tb
from simplex_tpu_torch.ops import batched_kernel, pivot_kernel
from simplex_tpu_torch.ops import tableau as tt
from simplex_tpu_torch.parallel import sharded as ps
from simplex_tpu_torch.runtime import counters, graphs

F64 = torch.float64
LOOP_CASES = ["dense_phase", "dual", "dual_bounded", "batched_le",
              "bounded_le", "batched_mixed", "bounded_mixed", "revised",
              "sharded", "sharded_classic"]


class _Counts:
    """Steps run and launches made by the loops, counted on the host."""

    def __init__(self):
        self.steps = 0              # steps that ran (not captured ones)
        self.k1_in_steps = 0        # K1 calls made by a running step
        self.noop_checks = 0
        self._in_step = False


@pytest.fixture
def counts(monkeypatch):
    """Wrap the kernel entry points the loops call so that each call counts
    as a launch, and ``graphs.steps`` so that each step that runs is
    counted; the counters start at 0."""
    c = _Counts()
    for mod, name in ((pivot_kernel, "LAUNCHES"),
                      (batched_kernel, "LAUNCHES"),
                      (batched_kernel, "LAUNCHES_K3")):
        monkeypatch.setattr(mod, name, 0)

    def counting(mod, counter, fn, in_step=False):
        def wrapped(*a, **kw):
            counters.add(vars(mod), counter)
            if in_step and c._in_step:
                c.k1_in_steps += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tt, "pivot_update_", counting(
        pivot_kernel, "LAUNCHES", tt.pivot_update_, in_step=True))
    monkeypatch.setattr(tb, "fused_pivot_step_", counting(
        batched_kernel, "LAUNCHES", tb.fused_pivot_step_))
    monkeypatch.setattr(tb, "fused_pivot_step_bounded_", counting(
        batched_kernel, "LAUNCHES_K3", tb.fused_pivot_step_bounded_))
    steps = graphs.steps

    def counted_steps(state, n_steps):
        for k in steps(state, n_steps):
            running = getattr(graphs._CAPTURING, "rec", None) is None
            c.steps += running
            c._in_step = running
            yield k
            c._in_step = False

    monkeypatch.setattr(graphs, "steps", counted_steps)
    return c


class _StepStub:
    """A CUDA graph's contract on the CPU, steps included.  The warm-up
    runs the chunk.  The capture records the chunk and its steps' parts
    (``begin_step``: the first step, then the loop's body under its
    ``go`` and step count) and runs nothing: the chunk runs as a capture
    sees it, and the state is put back.  A replay runs the chunk with
    ``go`` read on the host, and, like a replay on the card, counts no
    launch itself."""

    def __init__(self, device, pool):
        self.fn = None
        self.loops = []

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        entry = next(cell.cell_contents for cell in fn.__closure__
                     if isinstance(cell.cell_contents, graphs._Entry))
        saved = {k: v.clone() for k, v in entry.state.items()}
        fn()
        for k, v in saved.items():
            entry.state[k].copy_(v)
        self.fn = fn
        return 0

    def begin_step(self, loop):
        self.loops.append(loop)

    def end_step(self):
        pass

    def replay(self):
        counts = graphs._own_counters()
        self.fn()
        graphs._add_counters([a - b for a, b in
                              zip(counts, graphs._own_counters())])


@pytest.fixture
def stub(monkeypatch):
    """The graph path on CPU tensors with :class:`_StepStub`, a fresh
    cache and counters."""
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_new_graph", _StepStub)
    monkeypatch.setattr(graphs, "_new_pool", lambda device: None)
    monkeypatch.setattr(graphs, "_CACHE", collections.OrderedDict())
    for name in ("REPLAYS", "CAPTURES", "EAGER_CHUNKS"):
        monkeypatch.setattr(graphs, name, 0)
    return graphs


def _launches():
    return graphs._read_counters()[:3]


@pytest.mark.parametrize("case", LOOP_CASES)
def test_stub_graph_solve_gives_the_recorded_results_and_launches(
        case, counts, stub, monkeypatch):
    """Eager, then through the stub twice (the first run captures each
    chunk variant after its warm-up, the second replays them all): the
    recorded results and the eager launches each time."""
    runs = []
    for graphed in (False, True, True):
        monkeypatch.setattr(graphs, "_graphed", lambda device, g=graphed: g)
        before, steps = _launches(), counts.steps
        out = lc.CASES[case](CPU, F64)
        runs.append((lc.fingerprint(out),
                     [b - a for a, b in zip(before, _launches())],
                     counts.steps - steps))
    assert stub.CAPTURES > 0 and stub.REPLAYS > 0
    for fp, launches, steps in runs:
        assert fp == GOLDEN[case]
        assert (launches, steps) == runs[0][1:]
    # A capture holds a chunk's first step and, where the chunk has more,
    # the loop's body on its go and step count.
    for e in stub._CACHE.values():
        for (n_steps, *_), (g, _, launches) in e.graphs.items():
            assert g.loops[0] is None and len(launches) == len(g.loops)
            assert len(g.loops) == min(n_steps, 2)
            for go, count, n in g.loops[1:]:
                assert go is e.state["go"] and count is e.state["steps"]
                assert n == n_steps


@pytest.fixture
def jax_f64(monkeypatch):
    """JAX in 64-bit mode for the reference loops, with the status codes
    the loops write given as int32 (64-bit mode would widen the modules'
    Python ints to int64 against an int32 carry)."""
    for mod in (jt, jb, j_rev):
        for name in ("RUNNING", "STATUS_OPTIMAL", "STATUS_INFEASIBLE",
                     "STATUS_UNBOUNDED", "STATUS_ITERATION_LIMIT"):
            if isinstance(getattr(mod, name, None), int):
                monkeypatch.setattr(mod, name, np.int32(getattr(mod, name)))
    with jax.enable_x64(True):
        yield


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("devex", [True, False])
def test_dense_loop_runs_its_pivots_plus_one_step_a_chunk(devex, counts,
                                                          jax_f64):
    sf, kw = lc.dense_inputs(5 if devex else 8)
    ref = jt.solve_tableau(*_jnp(sf.tableau, sf.basis, sf.col_mask_p1,
                                 sf.col_mask_p2, sf.obj_row_p1,
                                 sf.obj_row_p2), devex=devex, **kw)
    reads = tt.STATE_READS
    st = tt.state_from_standard_form(sf, CPU, F64)
    _, _, status, iters = tt.solve_tableau(**st, devex=devex, **kw)
    chunks = tt.STATE_READS - reads
    assert (status, iters) == (int(ref[2]), int(ref[3]))
    assert chunks >= 4
    assert counts.k1_in_steps == counts.steps == iters + chunks


@pytest.mark.parametrize("bounded", [False, True])
def test_dual_loops_run_their_pivots_plus_one_step_a_chunk(bounded, counts,
                                                           jax_f64):
    if bounded:
        arrays, kw = lc.dual_bounded_inputs()
        ref = jt.solve_tableau_dual_bounded(*_jnp(*arrays), **kw)
        ref_iters = int(ref[4])
    else:
        arrays, kw = lc.dual_inputs()
        ref = jt.solve_tableau_dual(*_jnp(*arrays), **kw)
        ref_iters = int(ref[3])
    # The inputs came from a port solve: count from here.
    reads, steps, k1 = tt.STATE_READS, counts.steps, counts.k1_in_steps
    launches = pivot_kernel.LAUNCHES
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    if bounded:
        iters = tt.solve_tableau_dual_bounded(*t, **kw)[4]
    else:
        iters = tt.solve_tableau_dual(*t, **kw)[3]
    chunks = tt.STATE_READS - reads
    assert iters == ref_iters and chunks >= 2
    assert (counts.k1_in_steps - k1 == counts.steps - steps
            == pivot_kernel.LAUNCHES - launches == iters + chunks)


@pytest.mark.parametrize("bounded", [False, True])
def test_phase2_only_loops_launch_once_for_each_reference_iteration(
        bounded, counts):
    """The ``le-refactor`` loop cases of ``test_torch_batched.py`` and
    ``test_torch_bounded.py`` (float32, refactors every 8 steps), as those
    files run them against the JAX package."""
    if bounded:
        from test_torch_bounded import LOOP_CASES, _args, _compiled
        kw = LOOP_CASES["le-refactor"][2]
        cb = _compiled("le-refactor")
        ref_iters = int(jb.solve_tableau_batch_bounded(
            *_jnp(*_args(cb)), backend="pallas_interpret", **kw)[4])
        st = tb.batch_state_from_compiled(cb, CPU, torch.float32)
        iters = tb.solve_tableau_batch_bounded(**st, **kw)[4]
        launches = batched_kernel.LAUNCHES_K3
    else:
        from test_torch_batched import LOOP_CASES, _compiled
        kw = LOOP_CASES["le-refactor"][1]
        cb = _compiled("le-refactor")
        ref_iters = int(jb.solve_tableau_batch(
            *_jnp(cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
                  cb.obj_row_p1, cb.obj_row_p2, cb.need_p1),
            backend="pallas_interpret", **kw)[3])
        st = tb.batch_state_from_compiled(cb, CPU, torch.float32)
        iters = tb.solve_tableau_batch(**st, **kw)[3]
        launches = batched_kernel.LAUNCHES
    assert kw["phase2_only"] and iters == ref_iters > kw["refactor_every"]
    assert launches == counts.steps == ref_iters


@pytest.mark.parametrize("bounded", [False, True])
def test_general_batched_loop_launches_once_a_counted_step(bounded, counts):
    """The two-phase driver counts every step some instance runs (an
    instance waiting for its phase flip included), so its launches equal
    its ``iters``, as the ``phase2_only`` loop's do."""
    out = lc.CASES["bounded_mixed" if bounded else "batched_mixed"](CPU, F64)
    launches = (batched_kernel.LAUNCHES_K3 if bounded
                else batched_kernel.LAUNCHES)
    assert launches == counts.steps == int(out["iters"]) > 0


def test_revised_loop_runs_its_iterations_plus_each_verdict_step(counts,
                                                                 jax_f64):
    (A, b, ub, basis, art, phases), kw = lc.revised_inputs()
    J = jnp.asarray
    at_up = np.zeros(A.shape[1], bool)
    ref_state = j_rev._refactor(J(A), J(b), J(basis.astype(np.int32)),
                                J(at_up), J(ub)) + (J(basis), J(at_up))
    out = lc.revised(CPU, F64)
    iters, verdicts = 0, 0
    for phase2, cost, cm in phases:
        ref = j_rev._run_phase_revised(
            J(A), J(b), J(cost), J(cm), J(art), *ref_state, J(ub),
            jnp.int32(iters), jnp.bool_(phase2), devex=True, **kw)
        ref_state, iters = ref[:4], int(ref[4])
        k = int(phase2)
        assert (int(out[f"iters{k}"]), int(out[f"status{k}"])) == (
            iters, int(ref[5]))
        verdicts += int(ref[5]) in (STATUS_OPTIMAL, STATUS_UNBOUNDED)
    assert verdicts == 2
    assert counts.steps == iters + verdicts


@pytest.mark.parametrize("case", LOOP_CASES)
def test_a_step_entered_with_go_false_changes_nothing(case, counts,
                                                      monkeypatch):
    """After each chunk that ends with ``go`` false, one more step of the
    chunk body (a first step always runs) on a copy of the state leaves
    every tensor bit-equal but the step count."""
    run = graphs.Loop.run

    def checked_run(self, body, n_steps, *variant):
        run(self, body, n_steps, *variant)
        if bool(self.state["go"]):
            return
        copy = {k: v.clone() for k, v in self.state.items()}
        graphs._store(copy, body(copy, self.consts, self.static, 1,
                                 *variant))
        for k, v in self.state.items():
            if k != "steps":
                assert copy[k].dtype == v.dtype and (
                    copy[k].numpy().tobytes() == v.numpy().tobytes()), k
        counts.noop_checks += 1

    monkeypatch.setattr(graphs.Loop, "run", checked_run)
    assert lc.fingerprint(lc.CASES[case](CPU, F64)) == GOLDEN[case]
    assert counts.noop_checks >= 1


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_sharded_loop_runs_one_step_for_each_reference_iteration(
        name, counts, stub, monkeypatch):
    """``tests/test_torch_sharded.py``'s single-rank cases with a resync
    every 4 steps, so the host cuts chunks at the resyncs: eager, then
    twice through the stub (captures, then replays).  Every run gives the
    eager run's bits, is step-equal to the JAX function, and runs exactly
    one step for each of its iterations: at most the iterations plus one
    step a chunk, the bound of the other loops, and here no verdict step
    more, since the verdict's step is an iteration of the reference's
    ``while_loop`` too."""
    case = SINGLE[name]()
    kw = dict(refactor_every=4)
    ref = _jax_tableau(case, (1, 1), **kw)
    arrays, bounded = _compiled(case)
    mesh = ps.make_mesh(1, 1)
    chunks = []
    run = graphs.Loop.run

    def counted_run(self, *args):
        chunks.append(args[1:])
        run(self, *args)

    monkeypatch.setattr(graphs.Loop, "run", counted_run)
    runs = []
    for graphed in (False, True, True):
        monkeypatch.setattr(graphs, "_graphed", lambda device, g=graphed: g)
        chunks.clear()
        steps = counts.steps
        out = ps.solve_tableau_sharded(*ps.stage_shards(arrays, mesh, CPU),
                                       mesh=mesh, bounded=bounded, **kw)
        T, basis, obj, status, iters, at_upper = out
        _step_equal(ref, basis.numpy(), obj.numpy(), status.numpy(), iters,
                    at_upper.numpy())
        runs.append(lc.fingerprint(lc._out(T=T, basis=basis, obj=obj,
                                           status=status, at_upper=at_upper)))
        ran = counts.steps - steps
        assert ran == iters == int(ref[4]) <= iters + len(chunks)
        # A resync opens its chunk, and no chunk runs past the next one.
        for n_steps, resync, _ in chunks:
            assert 1 <= n_steps <= min(ps._CHUNK, kw["refactor_every"])
        assert sum(r for _, r, _ in chunks) == iters // 4
    assert stub.CAPTURES > 0 and stub.REPLAYS > 0
    assert runs[1] == runs[0] and runs[2] == runs[0]
