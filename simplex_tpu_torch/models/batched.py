"""Batched LP solving on torch (port of ``simplex_tpu/models/batched.py``).

Thousands of independent LP instances of one padded shape, solved together
on ``config.device`` by ``ops/batched.py::solve_tableau_batch``, whose step
runs through kernel K2 on a CUDA device, or, with native upper bounds
(``ub``), by ``solve_tableau_batch_bounded`` on kernel K3.  Entry points,
as in the JAX package:

* :func:`solve_lp_batch` / :meth:`BatchedSimplexSolver.solve_many` — a list
  of :class:`LinearProgram`s with one variable count, padded to a shared
  shape on the host;
* :meth:`BatchedSimplexSolver.solve_arrays` — a uniform array batch
  ``(c: (B,n), A: (B,m,n), b: (B,m), ops)``, assembled on the device
  (:func:`compile_batch_on_device`) and solved in one call, with optional
  upper bounds ``ub``;
* :func:`solve_lp_sweep` — a pile of unrelated LPs with general bounds,
  bucketed by shape on the host and solved bucket by bucket through
  ``solve_arrays``;
* :func:`solve_arrays_stream` — an iterable of uniform batches, each
  solved as ``solve_arrays`` solves it, batch k+1 staged and batch k
  certified while the device works.

Every verdict is f64-certified and untrusted ones are re-solved exactly on
the host (``models/certify.py``) when ``config.certify`` is on; a CUDA
all-``<=`` batch with ``b >= 0``, without or with bounds, is certified on
the card (:func:`_certify_on_device`), and only what the card does not
certify goes to the host.  A float32 all-``<=`` batch with bounds goes on
in float64 from where its loop stopped before it is certified
(``ops/batched.py::finish_bounded_f64``).

The numpy helpers (``_round_up``, ``BatchResult``, ``CompiledBatch``,
``_build_ub_ext``, ``compile_batch_uniform``, ``_batch_tol``,
``certify_uniform_result``) and :func:`solve_lp_sweep` are copied from the
JAX module as they are (``tests/test_torch_core.py`` holds them to it).
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SolverConfig, DEFAULT_CONFIG, resolve_dtype, torch_device
from ..core.problem import (
    OP_EQ,
    OP_LE,
    LinearProgram,
    STATUS_OPTIMAL,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    split_free_variables,
)
from ..ops import batched as batched_ops
from ..utils.profiling import count, recorded, trace_span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BatchResult:
    """Vectorized result of a batched solve."""

    x: np.ndarray          # (B, n) decision variables (user order)
    z: np.ndarray          # (B,) objective in the user sense
    fun: np.ndarray        # (B,) min-form objective
    status: np.ndarray     # (B,) int32 scipy-compatible codes
    success: np.ndarray    # (B,) bool
    nit: int               # shared loop trip count
    pivots: Optional[np.ndarray] = None  # (B,) per-instance pivot counts
    solve_time: float = 0.0
    basis: Optional[np.ndarray] = None   # (B, m_pad) final basis columns
    # Bounded solves: (B, n_pad) bool — nonbasic columns sitting AT their
    # finite upper bound (None for classic [0, inf) batches).
    at_upper: Optional[np.ndarray] = None
    # f64 certification (None when config.certify is off): certified[i] is
    # True iff instance i's verdict passed the host f64 KKT check — directly
    # for device optima, or via exact host re-solve for escalated instances
    # (models/certify.py).  escalated[i] marks the re-solved ones.
    certified: Optional[np.ndarray] = None
    escalated: Optional[np.ndarray] = None

    @property
    def n_optimal(self) -> int:
        return int(np.sum(self.status == STATUS_OPTIMAL))

    @property
    def n_escalated(self) -> int:
        return 0 if self.escalated is None else int(np.sum(self.escalated))


@dataclasses.dataclass
class LoopResult(BatchResult):
    """A :class:`BatchResult` of the port's device loop (``_run_batch``),
    with each instance's bound flips: ``pivots`` counts pivots and flips,
    so ``pivots - flips`` is the pivots (flips are zero without ``ub``)."""

    flips: Optional[np.ndarray] = None   # (B,) int32


@dataclasses.dataclass
class CompiledBatch:
    """Host-compiled batch ready for ``ops.batched.solve_tableau_batch``."""

    T0: np.ndarray          # (B, m_pad+1, n_pad+1)
    basis: np.ndarray       # (B, m_pad)
    col_mask_p1: np.ndarray
    col_mask_p2: np.ndarray
    obj_row_p1: np.ndarray
    obj_row_p2: np.ndarray
    need_p1: np.ndarray     # (B,)
    n_vars: int
    maximize: np.ndarray    # (B,) bool
    # (B, n_pad) upper bounds in tableau dtype (+inf on slack/artificial/
    # padding columns); None for classic [0, inf) batches.
    ub_ext: Optional[np.ndarray] = None


def _build_ub_ext(ub, B: int, n: int, n_pad: int, dtype):
    """Validate + pad user upper bounds to the tableau column layout.

    ``ub`` is (n,) or (B, n), entries in [0, +inf] (lb is 0 by convention
    — general lower bounds go through ``core.problem.normalize_bounds``
    first).  Returns (B, n_pad) with +inf on every non-structural column,
    or None when every bound is +inf (the classic kernel then runs).
    """
    if ub is None:
        return None
    ub = np.broadcast_to(np.asarray(ub, np.float64), (B, n))
    if np.any(np.isnan(ub)) or np.any(ub < 0.0):
        raise ValueError(
            "Las cotas superiores deben cumplir ub >= 0 (normalice las "
            "cotas inferiores primero con normalize_bounds).")
    if not np.any(np.isfinite(ub)):
        return None
    ub_ext = np.full((B, n_pad), np.inf, np.float64)
    ub_ext[:, :n] = ub
    return ub_ext.astype(dtype, copy=False)


def compile_batch_uniform(c: np.ndarray, A: np.ndarray, b: np.ndarray,
                          ops: np.ndarray, maximize,
                          row_pad: int = 8, col_pad: int = 128,
                          dtype=np.float32,
                          align_total: bool = True,
                          ub=None) -> CompiledBatch:
    """Vectorized standard-form compilation for a uniform-shape batch.

    The column layout is uniform across the batch (slack i at n+i,
    artificial i at n+m+i, dead slots masked per instance), so the whole
    tableau assembly is pure numpy broadcasting — no Python loop over
    instances.  ``ops`` may be a shared (m,) vector or per-instance
    (B, m); ``maximize`` a scalar or a (B,) bool array.
    """
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    ops = np.asarray(ops, np.int64)
    for name, arr in (("c", c), ("A", A), ("b", b)):
        if not np.all(np.isfinite(arr)):
            raise ValueError(
                f"Los datos del problema deben ser finitos: '{name}' "
                f"contiene NaN/Inf.")
    B, m, n = A.shape
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,)).copy()

    c_min = np.where(maximize[:, None], -c, c)

    # Row normalization: flip rows with negative rhs (flips the operator).
    neg = b < 0                                    # (B, m)
    A = np.where(neg[:, :, None], -A, A)
    b = np.where(neg, -b, b)
    ops2 = ops if ops.ndim == 2 else ops[None, :]
    ops_b = np.where(neg, -ops2, ops2)             # (B, m)

    # Column layout is operator-dependent and ops_b varies per instance when
    # rows were flipped, so build per-instance layouts via vectorized masks:
    # every inequality row gets a slack slot; every row gets an artificial
    # slot.  Unused artificial slots (<= rows) are masked out per instance.
    # This keeps the layout uniform: slack i at n+i, artificial i at n+m+i.
    # When NO instance needs artificials (all rows <= after normalization,
    # the tall-LP benchmark shape), the artificial block is dropped
    # entirely — it would otherwise double the tableau width, and every
    # pivot streams the full width (n_art = 0 ⇒ ~2x less HBM per pivot).
    is_le_pre = ops_b == OP_LE
    n_art = 0 if bool(np.all(is_le_pre)) else m
    n_cols = n + m + n_art
    # TPU f32 tiling is (8, 128) over the LAST TWO dims, so it is the TOTAL
    # tableau (m_pad + 1 rows, n_pad + 1 cols incl. the objective row and
    # RHS column) that must be tile-aligned — otherwise every pass over the
    # (B, 33, 129)-style array physically streams (40, 256) tiles, ~2.4x the
    # logical bytes.  Align totals: rows to 8, columns to 128.
    # ``align_total=False`` keeps m_pad itself a multiple of ``row_pad``
    # instead — required by the row-sharded path, which splits the constraint
    # rows (without the objective row) evenly across mesh devices.
    if align_total:
        m_pad = max(_round_up(m + 1, row_pad), row_pad) - 1
        n_pad = max(_round_up(n_cols + (m_pad - m) + 1, col_pad), col_pad) - 1
    else:
        m_pad = max(_round_up(m, row_pad), row_pad)
        n_pad = max(_round_up(n_cols + (m_pad - m), 8), col_pad)

    # Allocate the tableau DIRECTLY in the target dtype: the f64
    # intermediate doubled peak host memory, which is what caps the
    # 100k-row config-5 regime (a 100k x 100k f32 tableau is 40 GB; its
    # f64 twin would put assembly alone at 120 GB on a 125 GB host).
    # Assignments below cast f64 sources per-element; the small
    # objective/mask arrays stay f64 until the final cast.
    T = np.zeros((B, m_pad + 1, n_pad + 1), dtype=np.dtype(dtype))
    T[:, :m, :n] = A
    T[:, :m, n_pad] = b

    is_ineq = ops_b != OP_EQ                       # (B, m)
    is_le = ops_b == OP_LE
    sign = np.where(is_le, 1.0, -1.0) * is_ineq    # slack/surplus sign
    rows = np.arange(m)
    T[:, rows, n + rows] = sign

    # Artificials: needed for >= and = rows.
    need_art = ~is_le                              # (B, m)
    if n_art:
        T[:, rows, n + m + rows] = need_art.astype(np.float64)

    basis = np.where(is_le, n + rows[None, :], n + m + rows[None, :])
    basis = basis.astype(np.int32)                 # (B, m)

    basis_full = np.zeros((B, m_pad), np.int32)
    basis_full[:, :m] = basis
    # Padding rows: dedicated unit columns so the basis stays invertible.
    pad_rows = np.arange(m, m_pad)
    pad_cols = n_cols + (pad_rows - m)
    T[:, pad_rows, pad_cols] = 1.0
    basis_full[:, m:] = pad_cols[None, :].astype(np.int32)

    col_valid = np.zeros((B, n_pad), bool)
    col_valid[:, :n] = True
    col_valid[:, n:n + m] = is_ineq                # live slack columns
    art_live = np.zeros((B, n_pad), bool)
    if n_art:
        art_live[:, n + m:n + 2 * m] = need_art
    col_mask_p1 = col_valid | art_live
    col_mask_p2 = col_valid

    need_p1 = need_art.any(axis=1)

    obj_row_p1 = np.zeros((B, n_pad + 1), np.float64)
    obj_row_p2 = np.zeros((B, n_pad + 1), np.float64)
    obj_row_p2[:, :n] = c_min
    if n_art:
        obj_row_p1[:, n + m:n + 2 * m] = need_art.astype(np.float64)
        # Phase-1 objective row (priced out): r = -sum over artificial
        # rows, zero on the artificial columns themselves.
        art_rows_sum = np.einsum("bm,bmn->bn", need_art.astype(np.float64),
                                 T[:, :m, :])
        obj1 = -art_rows_sum
        obj1[:, n + m:n + 2 * m] = 0.0
        # Instances with no artificials start directly in phase 2: install
        # the priced-out phase-2 objective (initial basis is all-slack,
        # cost 0, so the raw row is already priced out).
        T[:, m_pad, :] = np.where(need_p1[:, None], obj1, obj_row_p2)
    else:
        T[:, m_pad, :] = obj_row_p2

    ub_ext = _build_ub_ext(ub, B, n, n_pad, dtype)
    if ub_ext is not None:
        # Fixed columns (ub == 0): x_j = 0 always — mask them out of both
        # phases (a zero-span variable would bound-flip forever).
        fixed = ub_ext[:, :n_pad] == 0.0
        col_mask_p1 &= ~fixed
        col_mask_p2 &= ~fixed

    return CompiledBatch(
        T0=T.astype(dtype, copy=False),
        basis=basis_full,
        col_mask_p1=col_mask_p1,
        col_mask_p2=col_mask_p2,
        obj_row_p1=obj_row_p1.astype(dtype, copy=False),
        obj_row_p2=obj_row_p2.astype(dtype, copy=False),
        need_p1=need_p1,
        n_vars=n,
        maximize=maximize,
        ub_ext=ub_ext,
    )


def _batch_inputs(c, A, b, ops, maximize, dtype):
    """Host side of the device assembly: the finiteness check, the static
    artificial-block decision and the raw arrays the device needs, in their
    device dtypes.  Returns ``(arrays, maximize, with_art)``, ``arrays``
    being ``[c, A, b, ops (int32, (1|B, m)), maximize]``."""
    A = np.asarray(A)
    B, m, n = A.shape
    for name, arr in (("c", c), ("A", A), ("b", b)):
        if not np.all(np.isfinite(np.asarray(arr))):
            raise ValueError(
                f"Los datos del problema deben ser finitos: '{name}' "
                f"contiene NaN/Inf.")
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,)).copy()
    dt = np.dtype(dtype)
    b_np = np.asarray(b)
    ops_np = np.asarray(ops, np.int64)
    ops2 = ops_np if ops_np.ndim == 2 else ops_np[None, :]
    with_art = bool(np.any(np.where(b_np < 0, -ops2, ops2) != OP_LE))
    arrays = [np.asarray(c, dt), A.astype(dt, copy=False), b_np.astype(dt),
              ops2.astype(np.int32), maximize]
    return arrays, maximize, with_art


def compile_batch_on_device(c, A, b, ops, maximize,
                            row_pad: int = 8, col_pad: int = 128,
                            dtype=np.float32,
                            align_total: bool = True,
                            ub=None, device="cuda") -> CompiledBatch:
    """Standard-form assembly of a uniform array batch on ``device``.

    The port of ``_assemble_batch_jit`` and its caller: the same tableau,
    basis, masks and objective rows as :func:`compile_batch_uniform`, as
    tensors on ``device`` (``T0`` and the cost rows in ``dtype``, ``basis``
    int32, masks bool); only the raw ``(c, A, b)`` travel to the device.
    Whether the artificial block exists is decided on the host, as in the
    JAX function: it is left out when every row is ``<=`` after the sign
    normalization, which halves the tableau's width.
    """
    tensors, maximize, with_art = _upload(c, A, b, ops, maximize, dtype,
                                          device)
    return _assemble_on_device(tensors, maximize, with_art, row_pad,
                               col_pad, align_total, ub)


def _upload(c, A, b, ops, maximize, dtype, device):
    """:func:`_batch_inputs`'s arrays uploaded to ``device``: returns
    ``(tensors, maximize, with_art)``."""
    arrays, maximize, with_art = _batch_inputs(c, A, b, ops, maximize,
                                               dtype)
    dev = torch.device(device)
    return ([torch.as_tensor(a, device=dev) for a in arrays], maximize,
            with_art)


def _assemble_on_device(tensors, maximize, with_art: bool,
                        row_pad: int = 8, col_pad: int = 128,
                        align_total: bool = True,
                        ub=None) -> CompiledBatch:
    """The device half of :func:`compile_batch_on_device`: ``tensors`` are
    :func:`_batch_inputs`'s arrays on the device (uploaded there or staged
    by ``runtime/staging.py``).  Its layout defaults are the solves'
    (``solve_arrays``, ``solve_arrays_stream``)."""
    c_t, A_t, b_t, ops_t, max_t = tensors
    dev, dt = A_t.device, A_t.dtype
    B, m, n = A_t.shape
    c_min = torch.where(max_t[:, None], -c_t, c_t)

    neg = b_t < 0
    A_t = torch.where(neg[:, :, None], -A_t, A_t)
    b_t = torch.where(neg, -b_t, b_t)
    ops_b = torch.where(neg, -ops_t, ops_t)                 # (B, m)

    n_art = m if with_art else 0
    n_cols = n + m + n_art
    if align_total:
        m_pad = max(_round_up(m + 1, row_pad), row_pad) - 1
        n_pad = max(_round_up(n_cols + (m_pad - m) + 1, col_pad),
                    col_pad) - 1
    else:
        m_pad = max(_round_up(m, row_pad), row_pad)
        n_pad = max(_round_up(n_cols + (m_pad - m), 8), col_pad)

    rows = torch.arange(m, device=dev)
    is_ineq = ops_b != OP_EQ
    is_le = ops_b == OP_LE
    sign = torch.where(is_le, 1.0, -1.0).to(dt) * is_ineq.to(dt)
    need_art = ~is_le

    T = torch.zeros((B, m_pad + 1, n_pad + 1), dtype=dt, device=dev)
    T[:, :m, :n] = A_t
    T[:, :m, n_pad] = b_t
    T[:, rows, n + rows] = sign
    if with_art:
        T[:, rows, n + m + rows] = need_art.to(dt)
    pad_rows = torch.arange(m, m_pad, device=dev)
    pad_cols = n_cols + (pad_rows - m)
    T[:, pad_rows, pad_cols] = 1.0

    basis = torch.where(is_le, n + rows, n + m + rows).to(torch.int32)
    basis_full = torch.cat(
        [basis, pad_cols.to(torch.int32)[None, :].expand(B, m_pad - m)],
        dim=1).contiguous()

    col_mask_p2 = torch.zeros((B, n_pad), dtype=torch.bool, device=dev)
    col_mask_p2[:, :n] = True
    col_mask_p2[:, n:n + m] = is_ineq                       # live slacks
    obj_row_p2 = torch.zeros((B, n_pad + 1), dtype=dt, device=dev)
    obj_row_p2[:, :n] = c_min
    obj_row_p1 = torch.zeros((B, n_pad + 1), dtype=dt, device=dev)
    if with_art:
        col_mask_p1 = col_mask_p2.clone()
        col_mask_p1[:, n + m:n + 2 * m] = need_art
        need_p1 = need_art.any(dim=1)
        obj_row_p1[:, n + m:n + 2 * m] = need_art.to(dt)
        # Priced-out phase-1 row: minus the sum of the artificial rows,
        # zero on the artificial columns themselves.
        obj1 = -torch.bmm(need_art.to(dt)[:, None, :], T[:, :m, :])[:, 0]
        obj1[:, n + m:n + 2 * m] = 0.0
        T[:, m_pad, :] = torch.where(need_p1[:, None], obj1, obj_row_p2)
    else:
        col_mask_p1 = col_mask_p2
        need_p1 = torch.zeros((B,), dtype=torch.bool, device=dev)
        T[:, m_pad, :] = obj_row_p2

    dt_np = np.dtype(str(dt).replace("torch.", ""))
    ub_ext = _build_ub_ext(ub, B, n, n_pad, dt_np)
    if ub_ext is not None:
        live = torch.as_tensor(ub_ext != 0.0, device=dev)  # fixed columns
        col_mask_p1 = col_mask_p1 & live
        col_mask_p2 = col_mask_p2 & live
    return CompiledBatch(
        T0=T, basis=basis_full, col_mask_p1=col_mask_p1,
        col_mask_p2=col_mask_p2, obj_row_p1=obj_row_p1,
        obj_row_p2=obj_row_p2, need_p1=need_p1, n_vars=n,
        maximize=maximize, ub_ext=ub_ext,
    )


def _run_batch(cb: CompiledBatch, config: SolverConfig,
               max_iters: Optional[int] = None,
               _on_first_chunk=None) -> LoopResult:
    """Solve a compiled batch on ``config.device``: the classic solver, or
    the bounded one when ``cb.ub_ext`` is set.  ``cb`` may hold numpy
    arrays (either package's) or tensors; the tableau's own dtype is the
    working dtype.  ``_on_first_chunk`` (private): called once, right after
    the solve loop's first chunk has been enqueued.  A bounded solve adds
    its bound flips to the open solve record's count ``bound_flips``; a
    bounded float32 ``phase2_only`` solve whose verdicts will be certified
    takes its optimal instances on in float64
    (``ops/batched.py::finish_bounded_f64``, span ``batched.finish``; its
    steps and K3 launches counted as ``finish_steps`` and
    ``finish_launches``)."""
    t0 = time.perf_counter()
    dtype = np.dtype(str(cb.T0.dtype).replace("torch.", ""))
    _, torch_dtype = resolve_dtype(dtype.name)
    device = torch.device(config.device)
    if device.type == "cuda":
        # The refactor's and the polish's matrix products in full f32, as
        # the reference runs them (TF32 keeps about three digits).
        torch.backends.cuda.matmul.allow_tf32 = False
    st = batched_ops.batch_state_from_compiled(cb, device, torch_dtype)
    m_pad = st["basis0"].shape[1]
    n_pad = st["col_mask_p1"].shape[1]
    if max_iters is None:
        max_iters = min(config.max_iters, 50 * (m_pad + n_pad))
    bland_after = min(config.bland_after, max_iters // 2)

    # All-phase-2 batch (every row <= after sign normalization): the
    # solve loop without phase flips.
    phase2_only = not bool(st["need_p1"].any())
    kw = dict(
        tol=_batch_tol(config, dtype),
        max_iters=int(max_iters),
        bland_after=int(bland_after),
        refactor_every=int(config.refactor_every or max(64, m_pad // 8)),
        backend=config.batched_backend,
        devex=config.pivot_rule == "devex",
        phase2_only=phase2_only,
    )
    at_upper = None
    ub = st.pop("ub", None)
    # The solvers' common loop (solve_tableau_batch / _bounded), with the
    # private callback.
    T, basis, at_up, status, iters, pivots, flips = batched_ops._solve_loop(
        **st, ub=ub, feas_tol=1e-5, **kw, _on_first_chunk=_on_first_chunk)
    if ub is not None:
        if phase2_only and config.certify and torch_dtype == torch.float32:
            # Certified verdicts: the optimal instances go on in float64
            # first, so that float32 rounding does not send them to the
            # exact host engine.
            with trace_span("batched.finish"):
                x, z_min, status, basis, at_up, steps, launches = \
                    batched_ops.finish_bounded_f64(
                        T, st["T0"], st["basis0"], st["col_mask_p2"],
                        st["obj_row_p2"], ub, basis, at_up, status,
                        cb.n_vars, tol=min(_batch_tol(config, np.float64),
                                           _FINISH_TOL),
                        **{k: kw[k] for k in ("max_iters", "bland_after",
                                              "refactor_every", "backend",
                                              "devex")})
                count("finish_steps", int(steps.sum()))
                count("finish_launches", launches)
        else:
            x, z_min = batched_ops.extract_solution_batch_bounded(
                T, basis, at_up, ub, cb.n_vars)
        at_upper = at_up.cpu().numpy()
    else:
        x, z_min = batched_ops.extract_solution_batch(T, basis, cb.n_vars)
    x = np.maximum(x.cpu().numpy().astype(np.float64), 0.0)
    fun = z_min.cpu().numpy().astype(np.float64)
    status = status.cpu().numpy()
    flips = flips.cpu().numpy()
    if ub is not None:
        count("bound_flips", int(flips.sum()))
    z = np.where(cb.maximize, -fun, fun) + 0.0
    ok = status == STATUS_OPTIMAL
    return LoopResult(
        x=np.where(ok[:, None], x, np.nan),
        z=np.where(ok, z, np.nan),
        fun=np.where(ok, fun, np.nan),
        status=status,
        success=ok,
        nit=int(iters),
        pivots=pivots.cpu().numpy(),
        solve_time=time.perf_counter() - t0,
        basis=basis.cpu().numpy(),
        at_upper=at_upper,
        flips=flips,
    )


# The float64 finish's tolerance.  Its ratio test passes over the rows whose
# entry is at most the tolerance, and a step moves those by up to the
# tolerance times the step, unseen under the clipped right-hand side: a
# slack entering at 1e-6 moved a basic x_j of an mknapcb9 relaxation 2.3e-4
# beyond its bound of 1.
_FINISH_TOL = 1e-9


def _batch_tol(config: SolverConfig, dtype) -> float:
    """Working tolerance for the batched kernel, dtype-aware.

    f32 can't separate progress from round-off below ~1e-6, so the floor
    protects it; a float64 batch honours ``config.tol`` exactly like the
    dense path (``models/dense.py`` scales tol by dtype the same way).
    """
    if np.dtype(dtype) == np.float64:
        return float(config.tol)
    return float(max(config.tol, 1e-6))


def certify_uniform_result(res: BatchResult, c, A, b, ops, maximize,
                           row_pad: int = 8, col_pad: int = 128,
                           align_total: bool = True, tol: float = 1e-7,
                           chunk: int = 8192, ub=None) -> BatchResult:
    """f64-certify a uniform-batch result in place (models/certify.py).

    Recompiles the standard form in float64 per ``chunk`` of instances
    (bounded host memory even at 1M-instance sweeps), runs the batched KKT
    check against the exact data, and escalates every untrusted verdict to
    the exact host engine.  The layout parameters must match the solve.

    Bounded results (``ub`` given) and large-m batches route through the
    structured raw-data certifier, which knows the bounded KKT system and
    scales past the dense-LU regime.
    """
    from .certify import certify_and_escalate

    ops = np.asarray(ops)
    A = np.asarray(A)
    B = A.shape[0]
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,))
    certified = np.zeros((B,), bool)
    escalated = np.zeros((B,), bool)
    # Result arrays may be zero-copy views of device buffers (read-only).
    res.status = np.array(res.status)
    res.x = np.array(res.x)
    res.fun = np.array(res.fun)
    res.z = np.array(res.z)
    if np.all(ops == OP_LE):
        # All-<= sweep (shared or per-instance ops vector): the fully-
        # vectorized structured certifier (one batched LAPACK pair
        # straight from raw data — ~17x the chunked standard-form path,
        # the 1M-exact-sweep enabler).  Returns None when some b < 0
        # (row flips create artificials) — fall through.
        from .certify import certify_sweep_le_f64

        fix = certify_sweep_le_f64(res.status, res.basis, c, A, b,
                                   maximize, ub=ub, at_upper=res.at_upper,
                                   tol=tol)
        if fix is not None:
            res.status = fix["status"]
            res.x = fix["x"]
            res.fun = fix["fun"]
            res.z = fix["z"]
            res.success = res.status == STATUS_OPTIMAL
            res.certified = fix["certified"]
            res.escalated = fix["escalated"]
            return res
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    if ub is not None or A.shape[1] >= 512:
        # Large-m regime: the structured certifier (k×k LU per instance,
        # k <= n) replaces the dense m×m batched LU, which is O(m^3) host
        # LAPACK — prohibitive from ~16k rows (VERDICT r3 item 2).  It is
        # also the only certifier that knows the bounded KKT system.
        from .certify import certify_and_escalate_raw

        fix = certify_and_escalate_raw(
            res.status, res.basis, c, A, b, ops, maximize, tol=tol,
            ub=ub, at_upper=res.at_upper)
        res.status = fix["status"]
        res.x = fix["x"]
        res.fun = fix["fun"]
        res.z = fix["z"]
        res.success = res.status == STATUS_OPTIMAL
        res.certified = fix["certified"]
        res.escalated = fix["escalated"]
        return res
    for start in range(0, B, chunk):
        end = min(start + chunk, B)
        ops_chunk = ops if ops.ndim == 1 else ops[start:end]
        cb64 = compile_batch_uniform(
            c[start:end], A[start:end], b[start:end], ops_chunk,
            maximize[start:end], row_pad=row_pad, col_pad=col_pad,
            dtype=np.float64, align_total=align_total)
        m_pad = cb64.basis.shape[1]
        n_pad = cb64.col_mask_p1.shape[1]

        def mk(i, _s=start, _ops=ops_chunk):
            return LinearProgram(
                c=c[_s + i], A=A[_s + i], b=b[_s + i],
                ops=_ops if _ops.ndim == 1 else _ops[i],
                maximize=bool(maximize[_s + i]))

        fix = certify_and_escalate(
            res.status[start:end], res.basis[start:end],
            cb64.T0[:, :m_pad, :n_pad], cb64.T0[:, :m_pad, n_pad],
            cb64.obj_row_p2[:, :n_pad],
            cb64.col_mask_p1 & ~cb64.col_mask_p2, cb64.col_mask_p2,
            mk, maximize[start:end], cb64.n_vars, tol=tol,
            c1_std=cb64.obj_row_p1[:, :n_pad], mask_p1=cb64.col_mask_p1)
        certified[start:end] = fix["certified"]
        escalated[start:end] = fix["escalated"]
        res.status[start:end] = fix["status"]
        res.x[start:end] = fix["x"]
        res.fun[start:end] = fix["fun"]
        res.z[start:end] = fix["z"]
    res.success = res.status == STATUS_OPTIMAL
    res.certified = certified
    res.escalated = escalated
    return res


# The float64 KKT check's tolerance: the host copy's, which the card's check
# shares.
_CERT_TOL = inspect.signature(certify_uniform_result).parameters["tol"].default


def _certifies_on_device(A_t, b, ops, ub) -> bool:
    """Whether :func:`_certify_on_device` takes a batch: its tensors on a
    CUDA device, every row ``<=`` with ``b >= 0``, rows within the kernel's
    limit, and no upper bounds or ``ub`` of shape (n,) or (B, n) with
    entries in [0, +inf]."""
    from ..ops.certify_kernel import MAX_ROWS

    B, m, n = A_t.shape
    if not (A_t.device.type == "cuda" and 1 <= m <= MAX_ROWS and n >= 1
            and bool(np.all(np.asarray(ops) == OP_LE))
            and not bool(np.any(np.asarray(b) < 0))):
        return False
    if ub is None:
        return True
    ub = np.asarray(ub)
    return ub.shape in ((n,), (B, n)) and bool(np.all(ub >= 0))


def _certify_on_device(res: BatchResult, c, A, b, ops, maximize,
                       tensors, ub=None) -> BatchResult:
    """:func:`certify_uniform_result` of an all-``<=`` batch with ``b >= 0``,
    without or with upper bounds ``ub``, on the solve's device, in place.

    ``tensors`` are :func:`_upload`'s (the raw ``c``, ``A``, ``b`` in the
    solve's dtype, the ops and ``maximize``).  The float64 KKT check of
    every instance runs in one launch of the certifier kernel
    (``ops/certify_kernel.py::certify_le_``, ``csrc/certify_bounded.cu``),
    with ``ub`` and the solve's ``at_upper`` where the batch has bounds; it
    reads ``A``, ``b``, ``c`` and ``ub`` as the user gave them: an upload is
    reused where it holds the exact values, else the array goes up again in
    float64 (``ub`` goes up in its own float32 or float64).  The instances
    it does not certify, every non-optimal claim among them, go as one
    sub-batch, with their ``ub`` and ``at_upper`` rows, to the host copy
    :func:`certify_uniform_result`, which checks them again and escalates
    them as it does a whole batch; the solve record counts them as
    ``certify_fallback``.
    """
    from ..ops.certify_kernel import certify_le_

    c_t, A_t, b_t, _, max_t = tensors
    dev = A_t.device
    with trace_span("certify.device"):
        exact = []
        for arr, t in ((A, A_t), (b, b_t), (c, c_t)):
            arr = np.asarray(arr)
            if t.dtype == torch.float64 or arr.dtype == np.float32:
                exact.append(t)
            else:
                exact.append(torch.as_tensor(np.asarray(arr, np.float64),
                                             device=dev))
        basis = torch.as_tensor(np.ascontiguousarray(res.basis, np.int32),
                                device=dev)
        status = torch.as_tensor(np.asarray(res.status, np.int32),
                                 device=dev)
        ub_t = up_t = None
        if ub is not None:
            ub = np.asarray(ub)
            ub_t = torch.as_tensor(np.ascontiguousarray(
                ub if ub.dtype in (np.float32, np.float64)
                else ub.astype(np.float64)), device=dev)
            if res.at_upper is not None:
                up_t = torch.as_tensor(
                    np.ascontiguousarray(res.at_upper, bool), device=dev)
        ok_t, x_t, fun_t = certify_le_(*exact, max_t, basis, status,
                                       _CERT_TOL, ub_t, up_t)
        certified = ok_t.cpu().numpy()
        x = x_t.cpu().numpy()
        fun = fun_t.cpu().numpy()
    solved = dataclasses.replace(res)
    res.status = np.array(res.status)
    res.x = x
    res.fun = fun
    res.z = np.where(maximize, -fun, fun) + 0.0
    res.certified = certified
    res.escalated = np.zeros_like(certified)
    bad = np.flatnonzero(~certified)
    count("certify_fallback", len(bad))
    if len(bad):
        ops = np.asarray(ops)
        sub = certify_uniform_result(
            BatchResult(
                x=solved.x[bad], z=solved.z[bad], fun=solved.fun[bad],
                status=solved.status[bad], success=solved.success[bad],
                nit=solved.nit,
                pivots=None if solved.pivots is None else solved.pivots[bad],
                basis=solved.basis[bad],
                at_upper=(None if solved.at_upper is None
                          else solved.at_upper[bad])),
            np.asarray(c)[bad], np.asarray(A)[bad], np.asarray(b)[bad],
            ops if ops.ndim == 1 else ops[bad], maximize[bad],
            ub=ub if ub is None or ub.ndim == 1 else ub[bad])
        for name in ("status", "x", "fun", "z", "certified", "escalated"):
            getattr(res, name)[bad] = getattr(sub, name)
    res.success = res.status == STATUS_OPTIMAL
    return res


# How close to its finite upper bound an escalated instance's variable must
# sit to be marked at it: the exact host engine's rounding (its
# equilibration scales and unscales x), far inside lpbench's 1e-9.
_AT_UPPER_RTOL = 1e-12


def _reset_at_upper(res: BatchResult, ub) -> BatchResult:
    """``at_upper`` of every escalated instance of a bounded, certified
    result, in place, from its ``x`` and ``ub``: the host certifiers
    (``certify_uniform_result``, copied as it is) rewrite an escalated
    instance's ``x``, status and objective from the exact host engine and
    leave the loop's ``at_upper`` as it was.  A structural column is at its
    upper bound where its bound is finite and ``x`` sits on it; every other
    column is not.  The solve record counts the instances reset as
    ``at_upper_reset``."""
    if res.at_upper is None or res.escalated is None:
        return res
    esc = np.flatnonzero(res.escalated)
    count("at_upper_reset", len(esc))
    if len(esc):
        x = np.asarray(res.x, np.float64)[esc]
        n = x.shape[1]
        u = np.broadcast_to(np.asarray(ub, np.float64),
                            (len(res.x), n))[esc]
        fin = np.isfinite(u)
        u = np.where(fin, u, 0.0)
        at = np.zeros((len(esc), res.at_upper.shape[1]), bool)
        at[:, :n] = fin & (np.abs(x - u) <= _AT_UPPER_RTOL * (1.0 + u))
        res.at_upper = np.array(res.at_upper)
        res.at_upper[esc] = at
    return res


class BatchedSimplexSolver:
    """Batched two-phase simplex over a shared padded shape, on
    ``config.device``."""

    def __init__(self, config: SolverConfig = DEFAULT_CONFIG):
        self.config = config

    @recorded("batched.solve_arrays")
    def solve_arrays(self, c, A, b, ops, maximize=True,
                     dtype=None, ub=None) -> BatchResult:
        """Uniform-shape path: the standard form is assembled on the device
        (:func:`compile_batch_on_device`) and solved in one call; with
        ``config.certify`` on (the default) every verdict is then
        f64-KKT-checked against the exact data and untrusted ones are
        re-solved by the exact host engine.  Each call is one solve record
        (``utils/profiling.py``) with the spans ``batched.assemble``,
        ``batched.run`` and ``batched.certify`` (with ``certify.device``
        inside where the card certifies, :func:`_certify_on_device`).  An
        escalated instance of a bounded batch gets ``at_upper`` anew from
        its ``x`` (:func:`_reset_at_upper`).

        ``ub`` ((n,) or (B, n), entries in [0, +inf]): native upper bounds,
        solved by the bounded solver (kernel K3) at zero row cost; general
        lower bounds are lowered first by ``core.problem.normalize_bounds``
        (see :func:`solve_lp_sweep`).
        """
        with trace_span("batched.assemble"):
            # compile_batch_on_device, keeping the raw uploads for the
            # certifier.
            tensors, maxi, with_art = _upload(
                c, A, b, ops, maximize,
                np.dtype(dtype or self.config.dtype), self.config.device)
            cb = _assemble_on_device(tensors, maxi, with_art, ub=ub)
        with trace_span("batched.run"):
            res = self._solve_compiled(cb)
        if self.config.certify:
            with trace_span("batched.certify"):
                if _certifies_on_device(tensors[1], b, ops, ub):
                    res = _certify_on_device(res, c, A, b, ops, maxi,
                                             tensors, ub=ub)
                else:
                    res = certify_uniform_result(res, c, A, b, ops,
                                                 maximize, ub=ub)
                res = _reset_at_upper(res, ub)
        return res

    def _solve_compiled(self, cb: CompiledBatch) -> BatchResult:
        return _run_batch(cb, self.config)

    def solve_many(self, lps: Sequence[LinearProgram]) -> BatchResult:
        """Same-variable-count convenience path: pad instances to one bucket.

        Constraint counts and operators may differ per instance; the number
        of decision variables must match (solution extraction reads the
        first ``n_vars`` columns of every instance).  The body is the JAX
        method's: the padding is numpy on the host.
        """
        assert lps, "empty batch"
        n_vars = {lp.n_vars for lp in lps}
        assert len(n_vars) == 1, (
            f"solve_many requires a uniform variable count, got {n_vars}"
        )
        n_user = lps[0].n_vars
        if any(lp.has_finite_bounds for lp in lps):
            # Convenience path: lower finite bounds onto rows per instance,
            # so one standard-form build feeds both the solve and the
            # certifier.
            lps = [lower_bounds_to_rows(lp) for lp in lps]
        free_maps = None
        if any(lp.has_free for lp in lps):
            # Lower free variables per instance (x = x+ - x-).  The split
            # columns sit right after the user columns, so extraction reads
            # the widest expanded width and each instance merges its own map.
            pairs = [split_free_variables(lp) for lp in lps]
            lps = [p[0] for p in pairs]
            free_maps = [p[1] for p in pairs]
        dtype = np.dtype(self.config.dtype)
        # Compile in f64: the same arrays feed both the (cast) device batch
        # and the f64 certification pass — one standard-form build, two uses.
        sfs = [compile_standard_form(lp, dtype=np.float64) for lp in lps]
        m_pad = max(sf.m_pad for sf in sfs)
        n_pad = max(sf.n_pad for sf in sfs)
        B = len(sfs)

        T0 = np.zeros((B, m_pad + 1, n_pad + 1), np.float64)
        basis = np.zeros((B, m_pad), np.int32)
        cm1 = np.zeros((B, n_pad), bool)
        cm2 = np.zeros((B, n_pad), bool)
        o1 = np.zeros((B, n_pad + 1), np.float64)
        o2 = np.zeros((B, n_pad + 1), np.float64)
        need = np.zeros((B,), bool)
        for i, sf in enumerate(sfs):
            mp, np_ = sf.m_pad, sf.n_pad
            T0[i, :mp, :np_] = sf.tableau[:mp, :np_]
            T0[i, :mp, n_pad] = sf.tableau[:mp, np_]        # RHS column
            T0[i, m_pad, :np_] = sf.tableau[mp, :np_]       # objective row
            T0[i, m_pad, n_pad] = sf.tableau[mp, np_]
            basis[i, :mp] = sf.basis
            # Extra padding rows (mp..m_pad) need their own unit columns.
            for k, row in enumerate(range(mp, m_pad)):
                col = np_ + k
                assert col < n_pad
                T0[i, row, col] = 1.0
                basis[i, row] = col
            cm1[i, :np_] = sf.col_mask_p1
            cm2[i, :np_] = sf.col_mask_p2
            o1[i, :np_] = sf.obj_row_p1[:np_]
            o1[i, n_pad] = sf.obj_row_p1[np_]
            o2[i, :np_] = sf.obj_row_p2[:np_]
            o2[i, n_pad] = sf.obj_row_p2[np_]
            need[i] = sf.need_phase1
            if not sf.need_phase1:
                # compile_standard_form leaves the objective row zero when
                # there is no phase 1; the batched kernel expects the
                # phase-2 row pre-installed (all-slack basis has zero cost,
                # so the raw row is already priced out).
                T0[i, m_pad, :np_] = sf.obj_row_p2[:np_]
                T0[i, m_pad, n_pad] = sf.obj_row_p2[np_]

        cb = CompiledBatch(
            T0=T0.astype(dtype), basis=basis, col_mask_p1=cm1,
            col_mask_p2=cm2, obj_row_p1=o1.astype(dtype),
            obj_row_p2=o2.astype(dtype), need_p1=need,
            n_vars=max(sf.n_vars for sf in sfs),
            maximize=np.array([lp.maximize for lp in lps]),
        )
        res = self._solve_compiled(cb)
        if self.config.certify:
            from .certify import certify_and_escalate

            fix = certify_and_escalate(
                res.status, res.basis,
                T0[:, :m_pad, :n_pad], T0[:, :m_pad, n_pad],
                o2[:, :n_pad], cm1 & ~cm2, cm2,
                lambda i: lps[i], cb.maximize, cb.n_vars,
                c1_std=o1[:, :n_pad], mask_p1=cm1)
            res = dataclasses.replace(
                res, status=fix["status"], x=fix["x"], fun=fix["fun"],
                z=fix["z"], success=fix["status"] == STATUS_OPTIMAL,
                certified=fix["certified"], escalated=fix["escalated"])
        if free_maps is not None:
            merged = np.stack([
                merge_free_solution(res.x[i], n_user, free_maps[i])
                for i in range(len(lps))
            ])
            res = dataclasses.replace(res, x=merged)
        return res


def solve_lp_batch(lps: Sequence[LinearProgram],
                   config: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Convenience wrapper: batched solve of a list of LinearPrograms."""
    return BatchedSimplexSolver(config).solve_many(lps)


def solve_lp_sweep(lps: Sequence[LinearProgram],
                   config: SolverConfig = DEFAULT_CONFIG):
    """Heterogeneous sweep: arbitrary LPs, bucketed + solved on device.

    The production entry for "solve this pile of unrelated LPs fast"
    (SURVEY.md §7: "bucketed compilation for the batch path").  Per LP the
    host does ONE cheap transform pass (lower bounds shifted/flipped out
    by ``normalize_bounds``, free → split; remaining finite UPPER bounds
    stay NATIVE via the bounded ratio-test kernel, adding zero rows) and
    computes a bucket key from the RAW shape rounded up to a multiple of
    8 — no standard-form compile, no per-instance tableau assembly.  Each
    bucket pads its raw (c, A, b, ops) arrays to the bucket shape
    (vacuous ``0'x <= 1`` rows, zero-cost zero columns) and goes through
    :meth:`BatchedSimplexSolver.solve_arrays`, whose standard-form
    assembly runs ON DEVICE — so a 100k mixed-shape sweep spends its time
    on the chip, not in a numpy loop.  Certification (config.certify)
    applies per bucket like any uniform batch.

    Returns per-LP results in the ORIGINAL order as ``(x, z, status,
    success)`` tuples (x in the instance's own variable order; None when
    not optimal).
    """
    from collections import defaultdict

    from ..core.problem import normalize_bounds

    solver = BatchedSimplexSolver(config)
    prepared = []            # per lp: (lp_t, n_user, free_map, bounds_tr)
    buckets = defaultdict(list)
    for idx, lp in enumerate(lps):
        # NATIVE bounds (VERDICT r3 item 4): finite lower bounds are
        # shifted/flipped out by normalize_bounds and the remaining finite
        # UPPER bounds ride the bounded ratio-test kernel at zero row cost
        # — a bound-heavy sweep keeps m equal to the structural row count
        # instead of re-inflating it with dense bound rows.
        lp_t, tr = (normalize_bounds(lp) if lp.has_finite_bounds
                    else (lp, None))
        if tr is not None and tr.identity:
            tr = None
        fmap = None
        if lp_t.has_free:
            lp_t, fmap = split_free_variables(lp_t)
        prepared.append((lp_t, lp.n_vars, fmap, tr))
        m_b = _round_up(max(lp_t.n_cons, 1), 8)
        n_b = _round_up(lp_t.n_vars, 8)
        buckets[(m_b, n_b)].append(idx)

    results = [None] * len(lps)
    for (m_b, n_b), indices in buckets.items():
        Bk = len(indices)
        c = np.zeros((Bk, n_b))
        A = np.zeros((Bk, m_b, n_b))
        # Vacuous padding rows: 0'x <= 1 (never binding, slack basic).
        b = np.ones((Bk, m_b))
        ops_b = np.full((Bk, m_b), OP_LE, np.int64)
        maxi = np.zeros((Bk,), bool)
        ub = np.full((Bk, n_b), np.inf)
        any_ub = False
        for k, i in enumerate(indices):
            lp_t, _, _, _ = prepared[i]
            m, n = lp_t.n_cons, lp_t.n_vars
            c[k, :n] = lp_t.c
            A[k, :m, :n] = lp_t.A
            b[k, :m] = lp_t.b
            ops_b[k, :m] = lp_t.ops
            maxi[k] = lp_t.maximize
            if np.any(np.isfinite(lp_t.ub)):
                ub[k, :n] = lp_t.ub
                any_ub = True
        res = solver.solve_arrays(c, A, b, ops_b, maximize=maxi,
                                  ub=ub if any_ub else None)
        for k, i in enumerate(indices):
            ok = bool(res.success[k])
            lp_t, n_user, fmap, tr = prepared[i]
            x = None
            z = None
            if ok:
                x = np.asarray(res.x[k][: lp_t.n_vars], np.float64)
                if fmap is not None:
                    x = merge_free_solution(x, n_user, fmap)
                if tr is not None:
                    x = tr.restore_x(x)
                z = (float(lps[i].c @ x)
                     if (tr is not None or fmap is not None)
                     else float(res.z[k]))
            results[i] = (x, z, int(res.status[k]), ok)
    return results


def solve_arrays_stream(batches, config: SolverConfig = DEFAULT_CONFIG,
                        maximize=True):
    """Pipelined sweep over an iterable of ``(c, A, b, ops[, ub])`` batches.

    Same contract as the JAX function: one :class:`BatchResult` a batch, in
    order, each from the assembly and kernels of
    :meth:`BatchedSimplexSolver.solve_arrays` on that batch; a batch with a
    fifth element ``ub`` runs the bounded solver (K3), and bounded and
    classic batches may mix in one stream; ``config.certify`` certifies
    every batch, on the host copy (:func:`certify_uniform_result`), where
    ``solve_arrays`` certifies an all-``<=`` CUDA batch on the card
    (:func:`_certify_on_device`).

    The overlap the JAX function gets from asynchronous dispatch is explicit
    here, because the solve loop reads its state once a chunk and so blocks
    the host:

    * batch k+1's pinned buffers and device tensors are allocated before
      batch k's loop starts, and its raw ``(c, A, b)`` are copied into the
      buffers and uploaded on a side stream (``runtime/staging.py``) right
      after batch k's first chunk has been enqueued, so that the copies run
      beside that batch's steps; the compute stream waits on the upload's
      event before it assembles batch k+1 (``_assemble_on_device``);
    * batch k is certified on one worker thread, which touches numpy
      results only, while batch k+1 solves; batch k is yielded once its
      certificate is done.  Solve records are per thread, so each
      certificate is a record of its own there, of kind
      ``batched.certify`` (``utils/profiling.py``).

    Raises where ``config.device`` is a GPU and none is present.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..runtime import staging

    dev = torch_device(config.device)
    dtype = np.dtype(config.dtype)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(batch):
        arrays, maxi, with_art = _batch_inputs(*batch[:4], maximize, dtype)
        return (staging.stage(arrays, dev, side, defer=True), maxi,
                with_art, batch)

    @recorded("batched.certify")
    def certify(res, c, A, b, ops, maxi, ub):
        return _reset_at_upper(
            certify_uniform_result(res, c, A, b, ops, maxi, ub=ub), ub)

    it = iter(batches)
    try:
        nxt = stage(next(it))
    except StopIteration:
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None              # the previous batch's certificate
        while nxt is not None:
            staged, maxi, with_art, raw = nxt
            ub = raw[4] if len(raw) > 4 else None
            cb = _assemble_on_device(staged.tensors(), maxi, with_art,
                                     ub=ub)
            # The NEXT batch's buffers now; its uploads once this batch's
            # first chunk is enqueued.
            try:
                nxt = stage(next(it))
            except StopIteration:
                nxt = None
            res = _run_batch(cb, config, _on_first_chunk=(
                None if nxt is None else nxt[0].upload))
            del cb, staged
            if not config.certify:
                yield res
                continue
            done = pool.submit(certify, res, *raw[:4], maxi, ub=ub)
            if pending is not None:
                yield pending.result()
            pending = done
        if pending is not None:
            yield pending.result()
