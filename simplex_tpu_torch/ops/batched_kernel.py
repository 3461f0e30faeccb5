"""K2 and K3, the fused batched pivot steps: CUDA kernel wrappers and their
plain twins.

K2 is the port of ``simplex_tpu/ops/pallas_batched.py::fused_pivot_step``
(kernel body ``_make_kernel``); K3, of ``fused_pivot_step_bounded`` (body
``_make_kernel_bounded``), the same step with native upper bounds (see
:func:`fused_pivot_step_bounded_ref`).  For every instance of a batch of
tableaus, one K2 step does what the Pallas kernel does in one pass: pricing
(Dantzig, Devex or Bland's first eligible column, per instance), the
RHS-clamped ratio test with the Harris two-pass choice or Bland's
smallest-basis-index tie-break, the masked rank-1 update with the clamped
RHS lane, the Devex weight update, and the basis write.  Every function
here updates ``T``, ``basis``, the weights (and K3's bound state) IN PLACE
(each instance's data is owned by one CUDA block, so nothing is read after
another block wrote it; the kernels stage an instance's tile in shared
memory, decide there and write it back once, and need no scratch):

* :func:`fused_pivot_step_` and :func:`fused_pivot_step_bounded_` launch
  the hand-written kernels (``csrc/fused_pivot_step.cu``,
  ``csrc/fused_pivot_step_bounded.cu``) on CUDA tensors and run the twins
  on CPU tensors.  They raise on anything else; there is no fallback from a
  kernel to its twin.
* :func:`fused_pivot_step_ref` and :func:`fused_pivot_step_bounded_ref` are
  the plain PyTorch twins: the kernels' spec and the CPU path.

Rounding, as the reference's compiled step rounds it on the CPU (XLA
contracts a product feeding a sum into one fused multiply-add there): in
float32 the Harris numerator ``rhs_c + tol·(1+|rhs|)`` and the update
``T - col·prow`` are rounded once; the twin gets that by computing them in
float64 and rounding to float32 (the product of two float32 values is exact
in float64).  In float64 there is no wider type for the twin to do the same,
and the JAX tests run in float32 only, so float64 rounds every operation,
in the kernel and the twin alike.  Ties go to the lowest index everywhere,
as the reference's ``_first_where`` min-reductions give them.  K3 rounds
the same way; which of its sums are one fused multiply-add is listed in
:func:`fused_pivot_step_bounded_ref`.
"""
from __future__ import annotations

import math

import torch

from ..runtime import counters

RUNNING = -1
_INT_MAX = 2**31 - 1

# Kernel launches since the counter was last reset to 0, K2's and K3's.
# Incremented only where the CUDA kernel is launched, so a run can prove
# that its steps went through the kernel.
LAUNCHES = 0
LAUNCHES_K3 = 0


def fma_rn(a, b, c):
    """``a·b + c`` as the reference's compiled loops round it: once in
    float32 (via float64, where the product is exact), per operation in
    float64."""
    if c.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).to(torch.float32)
    return a * b + c


def _prepare(T, basis, cm1, cm2, phase, status, use_bland, weights):
    """Check the arguments and bring them to the kernel's types: bool masks
    and Bland flags, int32 phase and status, and (B, N) weights (a (B, N-1)
    input is padded with an RHS lane of 1, as the reference pads it).
    Returns the converted tensors and whether the weights were padded."""
    if not isinstance(T, torch.Tensor) or T.dim() != 3:
        raise ValueError("T must be a 3-D (B, M, N) tensor")
    if T.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"T must be float32 or float64, got {T.dtype}")
    if not T.is_contiguous():
        raise ValueError("T must be contiguous")
    B, M, N = T.shape
    if B == 0 or M < 2 or N < 2:
        raise ValueError(f"T must be (B>=1, M>=2, N>=2), got {tuple(T.shape)}")
    dev = T.device

    def on_dev(name, v):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, T on {dev}")
        return v

    on_dev("basis", basis)
    if basis.shape != (B, M - 1) or basis.dtype != torch.int32 \
            or not basis.is_contiguous():
        raise ValueError(f"basis must be a contiguous int32 (B, M-1) = "
                         f"{(B, M - 1)} tensor")
    masks = []
    for name, cm in (("cm1", cm1), ("cm2", cm2)):
        on_dev(name, cm)
        if cm.shape != (B, N):
            raise ValueError(f"{name} must be (B, N) = {(B, N)}")
        masks.append((cm if cm.dtype == torch.bool else cm > 0.5)
                     .contiguous())
    ints = []
    for name, v in (("phase", phase), ("status", status)):
        on_dev(name, v)
        if v.shape != (B,) or v.dtype.is_floating_point or v.dtype == \
                torch.bool:
            raise ValueError(f"{name} must be an integer (B,) tensor")
        ints.append(v.to(torch.int32).contiguous())
    # A tensor must already be on T's device: the solve loops' flags are,
    # and a captured chunk may copy nothing from the host.
    bland = on_dev("use_bland", use_bland if isinstance(
        use_bland, torch.Tensor) else torch.as_tensor(use_bland, device=dev))
    bland = (bland != 0).reshape(-1).expand(B).contiguous()
    if weights is None:
        w, padded = torch.ones((B, N), dtype=T.dtype, device=dev), False
    else:
        on_dev("weights", weights)
        if weights.dtype != T.dtype or not weights.is_contiguous():
            raise ValueError("weights must be contiguous, in T's dtype")
        if weights.shape == (B, N):
            w, padded = weights, False
        elif weights.shape == (B, N - 1):
            w = torch.cat([weights, torch.ones((B, 1), dtype=T.dtype,
                                               device=dev)], dim=1)
            padded = True
        else:
            raise ValueError(f"weights must be (B, N) or (B, N-1), got "
                             f"{tuple(weights.shape)}")
    return masks[0], masks[1], ints[0], ints[1], bland, w, padded


def _first_where(mask, idx):
    """Lowest index where ``mask`` holds (INT_MAX if none), per row."""
    return torch.where(mask, idx, _INT_MAX).amin(dim=-1)


def _step_ref(T, basis, cm1, cm2, phase, status, bland, w, tol, devex):
    """The twin's arithmetic on prepared tensors; updates T, basis, w in
    place and returns ``(s, r, optimal, unbounded, active)``."""
    B, M, N = T.shape
    dt, dev = T.dtype, T.device
    eps = torch.finfo(dt).eps
    tol_t = torch.full((), tol, dtype=dt, device=dev)
    in_p1 = (phase == 1)[:, None]
    live = (status == RUNNING)[:, None]

    # ---- pricing: entering column s ---------------------------------- #
    cm = torch.where(in_p1, cm1, cm2)
    rc = torch.where(cm, T[:, M - 1, :], math.inf)
    eligible = rc < -tol
    idx_n = torch.arange(N, dtype=torch.int32, device=dev)
    if devex:
        score = torch.where(eligible, (rc * rc) / w, -math.inf)
        s_price = _first_where(score == score.amax(-1, keepdim=True), idx_n)
    else:
        s_price = _first_where(rc == rc.amin(-1, keepdim=True), idx_n)
    s_bland = _first_where(eligible, idx_n)
    s = torch.where(bland, s_bland, s_price).clamp(0, N - 1)
    optimal = ~eligible.any(dim=-1)

    # ---- ratio test: leaving row r ----------------------------------- #
    col = T.gather(2, s.long()[:, None, None].expand(B, M, 1))[:, :, 0]
    colc = col[:, : M - 1]
    rhs = T[:, : M - 1, N - 1]
    positive = colc > tol
    rhs_c = torch.clamp_min(rhs, 0.0)
    safe_col = torch.where(positive, colc, 1.0)
    ratios = torch.where(positive, rhs_c / safe_col, math.inf)
    min_ratio = ratios.amin(-1, keepdim=True)
    unbounded = ~optimal & torch.isinf(min_ratio[:, 0])
    theta_relax = torch.where(
        positive, fma_rn(1.0 + rhs.abs(), tol_t, rhs_c) / safe_col, math.inf)
    theta_max = theta_relax.amin(-1, keepdim=True)
    cand = positive & (ratios <= theta_max)
    piv_big = torch.where(cand, colc, -math.inf).amax(-1, keepdim=True)
    idx_m = torch.arange(M - 1, dtype=torch.int32, device=dev)
    r_harris = _first_where(cand & (colc == piv_big), idx_m)
    near = ratios <= min_ratio + 64.0 * eps * (1.0 + min_ratio.abs())
    tie_key = torch.where(near & positive, basis, _INT_MAX)
    r_bland = _first_where(tie_key == tie_key.amin(-1, keepdim=True), idx_m)
    r = torch.where(bland, r_bland, r_harris).clamp(0, M - 2)

    # ---- masked rank-1 update ---------------------------------------- #
    active = live[:, 0] & ~optimal & ~unbounded
    rl = r.long()
    pivot = colc.gather(1, rl[:, None])
    safe = torch.where(active[:, None] & (pivot.abs() > 0), pivot, 1.0)
    prow = T.gather(1, rl[:, None, None].expand(B, 1, N))[:, 0, :]
    prow_n = prow / safe
    last = idx_n == N - 1
    prow_n = torch.where(last, torch.clamp_min(prow_n, 0.0), prow_n)

    if devex:
        sl = s.long()[:, None]
        w_s = w.gather(1, sl)
        j_out = basis.gather(1, rl[:, None])
        w_new = torch.maximum(w, (prow_n * prow_n) * w_s)
        w_new = torch.where(idx_n == j_out, torch.clamp_min(w_s, 1.0), w_new)
        w_new = torch.where(idx_n == s[:, None], 1.0, w_new)
        w_new = torch.where(w_new.amax(-1, keepdim=True) > 1e8, 1.0, w_new)
        w.copy_(torch.where(active[:, None], w_new, w))

    T_new = fma_rn(-col[:, :, None], prow_n[:, None, :], T)
    is_r = (torch.arange(M, device=dev) == rl[:, None])[:, :, None]
    is_s = (idx_n == s[:, None])[:, None, :]
    T_new = torch.where(is_r, prow_n[:, None, :], T_new)
    T_new = torch.where(is_s, is_r.to(dt), T_new)
    T.copy_(torch.where(active[:, None, None], T_new, T))
    hot_r = idx_m == r[:, None]
    basis.copy_(torch.where(active[:, None] & hot_r, s[:, None], basis))
    return s, r, optimal, unbounded, active


def fused_pivot_step_ref(T, basis, cm1, cm2, phase, status, use_bland,
                         weights=None, tol: float = 1e-6,
                         devex: bool = False):
    """One fused pricing + ratio test + pivot step for every instance, in
    plain PyTorch, in place.

    Arguments as the reference's ``fused_pivot_step``: ``T`` (B, M, N) with
    the objective row last and the RHS column last; ``basis`` (B, M-1)
    int32; ``cm1``/``cm2`` (B, N) phase-1/phase-2 column masks, bool or
    float (eligible where > 0.5), RHS lane 0; ``phase`` and ``status`` (B,)
    int32 (status ``RUNNING`` = -1 keeps an instance live); ``use_bland``
    (B,) or a scalar, nonzero selects Bland's rule; ``weights`` the Devex
    weights, (B, N-1) or (B, N) with the RHS lane padded to 1 (None: ones).

    Returns ``(T, basis, weights, s, r, optimal, unbounded, did_pivot)``:
    the first three are the input tensors, updated; ``s`` and ``r`` are
    int32 (B,), the flags bool (B,).  An instance that does not pivot is
    left bit-identical.
    """
    cm1, cm2, phase, status, bland, w, padded = _prepare(
        T, basis, cm1, cm2, phase, status, use_bland, weights)
    s, r, opt, unb, did = _step_ref(T, basis, cm1, cm2, phase, status,
                                    bland, w, float(tol), bool(devex))
    if padded:
        weights.copy_(w[:, :-1])
        w = weights
    return T, basis, w if weights is not None else None, s, r, opt, unb, did


def fused_pivot_step_(T, basis, cm1, cm2, phase, status, use_bland,
                      weights=None, tol: float = 1e-6, devex: bool = False):
    """The step of :func:`fused_pivot_step_ref` through K2, in place.

    A CUDA tensor goes to the kernel (built on first use), a CPU tensor to
    the twin; any other device raises.  Returns what the twin returns.
    """
    cm1_, cm2_, phase_, status_, bland, w, padded = _prepare(
        T, basis, cm1, cm2, phase, status, use_bland, weights)
    if T.device.type == "cpu":
        return fused_pivot_step_ref(T, basis, cm1, cm2, phase, status,
                                    use_bland, weights, tol, devex)
    if T.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {T.device}")
    from ..runtime import kernels

    lib = kernels.library()
    B, M, N = T.shape
    dev = T.device
    # From the graph's memory pool when a chunk is being captured.
    sr = torch.empty((2, B), dtype=torch.int32, device=dev)
    flags = torch.empty((3, B), dtype=torch.bool, device=dev)
    fn = (lib.k2_fused_pivot_step_f32 if T.dtype == torch.float32
          else lib.k2_fused_pivot_step_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(T.data_ptr(), B, M, N, basis.data_ptr(), cm1_.data_ptr(),
                 cm2_.data_ptr(), phase_.data_ptr(), status_.data_ptr(),
                 bland.data_ptr(), w.data_ptr(), float(tol),
                 int(bool(devex)), sr[0].data_ptr(), sr[1].data_ptr(),
                 flags[0].data_ptr(), flags[1].data_ptr(),
                 flags[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K2 fused_pivot_step launch failed: CUDA error {err}")
    counters.add(globals(), "LAUNCHES")
    if padded:
        weights.copy_(w[:, :-1])
        w = weights
    return (T, basis, w if weights is not None else None, sr[0], sr[1],
            flags[0], flags[1], flags[2])


# --------------------------------------------------------------------------
# K3: the bounded step


def _prepare_bounded(T, basis, at_upper, cm1, cm2, phase, status, use_bland,
                     weights, ub, ub_B, is_art_row, art_mask):
    """K2's checks and conversions, plus the bound state: ``at_upper``
    (B, N-1) and ``is_art_row`` (B, M-1) bool, ``ub`` (B, N-1) and ``ub_B``
    (B, M-1) in T's dtype, all contiguous (the step updates ``at_upper``,
    ``ub_B`` and ``is_art_row`` in place), and ``art_mask`` (B, N) bool or
    float (artificial where > 0.5).  Returns K2's tuple and the bool art
    mask."""
    prepared = _prepare(T, basis, cm1, cm2, phase, status, use_bland,
                        weights)
    B, M, N = T.shape
    for name, v, shape, dtype in (("at_upper", at_upper, (B, N - 1),
                                   torch.bool),
                                  ("is_art_row", is_art_row, (B, M - 1),
                                   torch.bool),
                                  ("ub", ub, (B, N - 1), T.dtype),
                                  ("ub_B", ub_B, (B, M - 1), T.dtype)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if v.device != T.device:
            raise ValueError(f"{name} is on {v.device}, T on {T.device}")
        if v.shape != shape or v.dtype != dtype or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor")
    if not isinstance(art_mask, torch.Tensor) or art_mask.device != T.device \
            or art_mask.shape != (B, N):
        raise ValueError(f"art_mask must be a (B, N) = {(B, N)} tensor on "
                         f"{T.device}")
    art = (art_mask if art_mask.dtype == torch.bool else art_mask > 0.5)
    return prepared, art.contiguous()


def _step_bounded_ref(T, basis, at_upper, cm1, cm2, phase, status, bland, w,
                      ub, ub_B, is_art_row, art, tol, devex, with_art):
    """The bounded twin's arithmetic on prepared tensors; updates T, basis,
    at_upper, w, ub_B and is_art_row in place and returns ``(s, r, optimal,
    unbounded, moving)``."""
    B, M, N = T.shape
    dt, dev = T.dtype, T.device
    eps = torch.finfo(dt).eps
    tol_t = torch.full((), tol, dtype=dt, device=dev)
    in_p1 = phase == 1
    live = status == RUNNING
    idx_n = torch.arange(N, dtype=torch.int32, device=dev)
    idx_m = torch.arange(M - 1, dtype=torch.int32, device=dev)
    at_up = torch.cat([at_upper, torch.zeros((B, 1), dtype=torch.bool,
                                             device=dev)], dim=1)

    # ---- two-sided pricing: entering column s ------------------------- #
    cm = torch.where(in_p1[:, None], cm1, cm2)
    obj = T[:, M - 1, :]
    rc = torch.where(cm, obj, 0.0)
    eligible = (cm & ~at_up & (rc < -tol)) | (cm & at_up & (rc > tol))
    viol = torch.where(eligible, rc.abs(), -math.inf)
    score = torch.where(eligible, (viol * viol) / w, -math.inf) if devex \
        else viol
    s_price = _first_where(score == score.amax(-1, keepdim=True), idx_n)
    s_bland = _first_where(eligible, idx_n)
    s = torch.where(bland, s_bland, s_price).clamp(0, N - 2)
    optimal = ~eligible.any(dim=-1)
    sl = s.long()[:, None]
    s_from_up = at_up.gather(1, sl)[:, 0]
    sigma = torch.where(s_from_up, -1.0, 1.0).to(dt)
    ub_s = ub.gather(1, sl)[:, 0]
    ub_s_safe = torch.where(torch.isfinite(ub_s), ub_s, 0.0)

    # ---- bounded ratio test over the constraint rows ------------------ #
    col = T.gather(2, sl[:, :, None].expand(B, M, 1))[:, :, 0]    # (B, M)
    dd_all = sigma[:, None] * col
    xB_all = T[:, :, N - 1]
    dd, xB = dd_all[:, : M - 1], xB_all[:, : M - 1]
    pos = dd > tol
    neg = (dd < -tol) & torch.isfinite(ub_B)
    span = ub_B - xB
    xB_c = torch.clamp_min(xB, 0.0)
    span_c = torch.clamp_min(span, 0.0)
    pos_dd = torch.where(pos, dd, 1.0)
    neg_dd = torch.where(neg, -dd, 1.0)
    t_lo = torch.where(pos, xB_c / pos_dd, math.inf)
    t_hi = torch.where(neg, span_c / neg_dd, math.inf)
    if with_art:
        art_exit = (~in_p1)[:, None] & is_art_row & (dd.abs() > tol)
        t_lo = torch.where(art_exit, 0.0, t_lo)
        cand = pos | neg | art_exit
    else:
        cand = pos | neg
    t_row = torch.minimum(t_lo, t_hi)
    min_row = t_row.amin(-1)
    theta = torch.minimum(min_row, ub_s)
    unbounded = ~optimal & torch.isinf(theta)
    flip = ~optimal & ~unbounded & (ub_s <= min_row)
    theta_safe = torch.where(torch.isfinite(theta), theta, 0.0)

    # Harris two-pass over both limits; Bland keeps basis-index ties.
    t_lo_rel = torch.where(
        pos, fma_rn(1.0 + xB.abs(), tol_t, xB_c) / pos_dd, math.inf)
    t_hi_rel = torch.where(
        neg, (span_c + tol_t * (1.0 + torch.where(neg, span, 0.0).abs()))
        / neg_dd, math.inf)
    theta_max = torch.minimum(t_lo_rel, t_hi_rel).amin(-1, keepdim=True)
    harris_cand = cand & (t_row <= theta_max)
    hval = dd.abs()
    if with_art:
        harris_cand = harris_cand | art_exit
        # The art-exit bonus is added in T's dtype, as the reference adds
        # it: in float32 every art-exit row rounds to 1e30 and ties.
        hval = hval + torch.where(art_exit, torch.full((), 1e30, dtype=dt,
                                                       device=dev), 0.0)
    hval = torch.where(harris_cand, hval, -math.inf)
    r_harris = _first_where(hval == hval.amax(-1, keepdim=True), idx_m)
    near = cand & (t_row <= (min_row + 64.0 * eps
                             * (1.0 + min_row.abs()))[:, None])
    tie_key = torch.where(near, basis, _INT_MAX)
    r_bland = _first_where(tie_key == tie_key.amin(-1, keepdim=True), idx_m)
    r = torch.where(bland, r_bland, r_harris).clamp(0, M - 2)
    rl = r.long()[:, None]
    leave_up = t_hi.gather(1, rl)[:, 0] < t_lo.gather(1, rl)[:, 0]

    active = live & ~optimal & ~unbounded
    do_pivot = active & ~flip
    do_flip = active & flip
    j_out = basis.gather(1, rl)

    # ---- pivot: rank-1 on every lane but the RHS ---------------------- #
    pivot = col.gather(1, rl)
    safe = torch.where(do_pivot[:, None] & (pivot.abs() > 0), pivot, 1.0)
    prow_n = T.gather(1, rl[:, :, None].expand(B, 1, N))[:, 0, :] / safe
    if devex:
        w_s = w.gather(1, sl)
        w_new = torch.maximum(w, (prow_n * prow_n) * w_s)
        w_new = torch.where(idx_n == j_out, torch.clamp_min(w_s, 1.0), w_new)
        w_new = torch.where(idx_n == s[:, None], 1.0, w_new)
        w_new = torch.where(w_new.amax(-1, keepdim=True) > 1e8, 1.0, w_new)
        w.copy_(torch.where(do_pivot[:, None], w_new, w))
    T_new = fma_rn(-col[:, :, None], prow_n[:, None, :], T)
    is_r = (torch.arange(M, device=dev) == rl)[:, :, None]
    T_new = torch.where(is_r, prow_n[:, None, :], T_new)
    T_new = torch.where((idx_n == s[:, None])[:, None, :], is_r.to(dt),
                        T_new)

    # ---- the RHS column: pivot, bound flip or pass-through ------------ #
    hot_r = idx_m == r[:, None]
    ub_B_new = torch.where(hot_r, ub_s[:, None], ub_B)
    x_enter = torch.where(s_from_up, ub_s_safe - theta_safe, theta_safe)
    xB_piv = fma_rn(-dd_all, theta_safe[:, None], xB_all)
    xB_piv[:, : M - 1] = torch.minimum(torch.clamp_min(torch.where(
        hot_r, x_enter[:, None], xB_piv[:, : M - 1]), 0.0), ub_B_new)
    xB_flip = fma_rn(-dd_all, ub_s_safe[:, None], xB_all)
    xB_flip[:, : M - 1] = torch.minimum(
        torch.clamp_min(xB_flip[:, : M - 1], 0.0), ub_B)
    newlast = torch.where(do_pivot[:, None], xB_piv,
                          torch.where(do_flip[:, None], xB_flip, xB_all))
    T_out = torch.where(do_pivot[:, None, None], T_new, T)
    T_out[:, :, N - 1] = newlast
    T.copy_(T_out)

    # ---- bookkeeping ------------------------------------------------- #
    piv_r = do_pivot[:, None] & hot_r
    basis.copy_(torch.where(piv_r, s[:, None], basis))
    idx_c = idx_n[: N - 1]
    s_hot = idx_c == s[:, None]
    atup_piv = torch.where(idx_c == j_out, leave_up[:, None], at_upper)
    atup_piv = atup_piv & ~s_hot
    at_upper.copy_(torch.where(do_pivot[:, None], atup_piv,
                               torch.where(do_flip[:, None],
                                           at_upper ^ s_hot, at_upper)))
    ub_B.copy_(torch.where(piv_r, ub_s[:, None], ub_B))
    if with_art:
        is_art_s = art.gather(1, sl)
        is_art_row.copy_(torch.where(piv_r, is_art_s, is_art_row))
    return s, r, optimal, unbounded, active


def fused_pivot_step_bounded_ref(T, basis, at_upper, cm1, cm2, phase, status,
                                 use_bland, weights, ub, ub_B, is_art_row,
                                 art_mask, tol: float = 1e-6,
                                 devex: bool = False, with_art: bool = True):
    """One fused bounded step (``0 <= x <= ub``) for every instance, in
    plain PyTorch, in place: the twin of K3.

    Arguments beyond K2's (:func:`fused_pivot_step_ref`), as the
    reference's ``fused_pivot_step_bounded``: ``at_upper`` (B, N-1) bool,
    the nonbasic columns at their upper bound; ``ub`` (B, N-1) upper bounds
    (+inf where unbounded); ``ub_B`` (B, M-1) the basic rows' upper bounds;
    ``is_art_row`` (B, M-1) bool, the rows whose basic variable is
    artificial; ``art_mask`` (B, N) the artificial columns; ``with_art``
    enables the artificial-exit rows of phase 2 (off in a batch without
    artificial columns).

    The step: two-sided pricing (a column enters from its lower bound when
    rc < -tol, from its upper bound, sign σ = -1, when rc > tol); the
    bounded ratio test, limited by a basic variable reaching 0 or its own
    upper bound, both clamped; θ = min(min ratio, ub_s), a bound flip when
    ub_s <= the min ratio (no basis change); the Harris choice over both
    limits, art-exit rows first; the rank-1 update of every lane but the
    RHS, whose column is recomputed (``x_B - σ d θ``, the entering row at
    θ or ub_s - θ, the constraint rows clipped to [0, ub_B]); then the
    at-upper, ub_B, is_art_row, basis and Devex bookkeeping.  In float32
    four sums round once, as XLA contracts them into fused multiply-adds
    in the reference's compiled kernel (PERF.md): the lower Harris
    numerator ``xB_c + tol·(1+|xB|)``, the update ``T - col·prow``, and
    the RHS steps ``xB - dd·θ`` and ``xB - dd·ub_s``; the upper Harris
    numerator ``span_c + tol·(1+|ub_B - xB|)`` rounds its product and its
    sum apart, as the reference's kernel does.

    Returns ``(T, basis, at_upper, weights, ub_B, is_art_row, s, r,
    optimal, unbounded, moving)``: the first six are the input tensors,
    updated; ``moving`` marks a pivot or a flip.  An instance that does
    neither is left bit-identical; a flip writes only its RHS column and
    ``at_upper``.
    """
    (cm1, cm2, phase, status, bland, w, padded), art = _prepare_bounded(
        T, basis, at_upper, cm1, cm2, phase, status, use_bland, weights, ub,
        ub_B, is_art_row, art_mask)
    flags = _step_bounded_ref(T, basis, at_upper, cm1, cm2, phase, status,
                              bland, w, ub, ub_B, is_art_row, art, float(tol),
                              bool(devex), bool(with_art))
    if padded:
        weights.copy_(w[:, :-1])
        w = weights
    return (T, basis, at_upper, w if weights is not None else None, ub_B,
            is_art_row) + flags


def fused_pivot_step_bounded_(T, basis, at_upper, cm1, cm2, phase, status,
                              use_bland, weights, ub, ub_B, is_art_row,
                              art_mask, tol: float = 1e-6, devex: bool = False,
                              with_art: bool = True):
    """The step of :func:`fused_pivot_step_bounded_ref` through K3, in place.

    A CUDA tensor goes to the kernel (built on first use), a CPU tensor to
    the twin; any other device raises.  Returns what the twin returns.
    """
    if isinstance(T, torch.Tensor) and T.device.type == "cpu":
        return fused_pivot_step_bounded_ref(
            T, basis, at_upper, cm1, cm2, phase, status, use_bland, weights,
            ub, ub_B, is_art_row, art_mask, tol, devex, with_art)
    (cm1_, cm2_, phase_, status_, bland, w, padded), art = _prepare_bounded(
        T, basis, at_upper, cm1, cm2, phase, status, use_bland, weights, ub,
        ub_B, is_art_row, art_mask)
    if T.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda or cpu tensors, not {T.device}")
    from ..runtime import kernels

    lib = kernels.library()
    B, M, N = T.shape
    dev = T.device
    # From the graph's memory pool when a chunk is being captured.
    sr = torch.empty((2, B), dtype=torch.int32, device=dev)
    flags = torch.empty((3, B), dtype=torch.bool, device=dev)
    fn = (lib.k3_fused_pivot_step_bounded_f32 if T.dtype == torch.float32
          else lib.k3_fused_pivot_step_bounded_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(T.data_ptr(), B, M, N, basis.data_ptr(),
                 at_upper.data_ptr(), cm1_.data_ptr(), cm2_.data_ptr(),
                 phase_.data_ptr(), status_.data_ptr(), bland.data_ptr(),
                 w.data_ptr(), ub.data_ptr(), ub_B.data_ptr(),
                 is_art_row.data_ptr(), art.data_ptr(), float(tol),
                 int(bool(devex)), int(bool(with_art)), sr[0].data_ptr(),
                 sr[1].data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
                 flags[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K3 fused_pivot_step_bounded launch failed: CUDA error {err}")
    counters.add(globals(), "LAUNCHES_K3")
    if padded:
        weights.copy_(w[:, :-1])
        w = weights
    return (T, basis, at_upper, w if weights is not None else None, ub_B,
            is_art_row, sr[0], sr[1], flags[0], flags[1], flags[2])
