"""K1, the rank-1 pivot update: CUDA kernel wrapper and its plain twin.

Port of ``simplex_tpu/ops/pallas_pivot.py::pivot_update_fused`` as the
production form of ``simplex_tpu/ops/tableau.py::pivot_update`` (with the
``clamp_rhs`` option the Pallas kernel lacks).  Both functions here update
the tableau IN PLACE, which saves the second tableau a functional update
would allocate:

* :func:`pivot_update_` launches the hand-written kernel
  (``csrc/pivot_update.cu``) on a CUDA tensor and runs the twin on a CPU
  tensor.  It raises on anything else; there is no fallback from the kernel
  to the twin.
* :func:`pivot_update_ref` is the plain PyTorch twin: the kernel's spec and
  the CPU path.

``r`` and ``s`` are 0-d int64 tensors and ``do_pivot`` a 0-d bool tensor on
the tableau's device, so a solve loop on the GPU never reads them back to
the host; ``do_pivot`` False leaves ``T`` bit-identical.
"""
from __future__ import annotations

import torch

# Kernel launches since the counter was last reset to 0.  Incremented only
# where the CUDA kernel is launched, so a run can prove that its pivots went
# through the kernel.
LAUNCHES = 0


def _check(T, r, s, do_pivot):
    if not isinstance(T, torch.Tensor) or T.dim() != 2:
        raise ValueError("T must be a 2-D tensor")
    if T.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"T must be float32 or float64, got {T.dtype}")
    if not T.is_contiguous():
        raise ValueError("T must be contiguous")
    if T.shape[0] == 0 or T.shape[1] == 0:
        raise ValueError(f"T must be non-empty, got shape {tuple(T.shape)}")
    for name, v, dt in (("r", r, torch.int64), ("s", s, torch.int64),
                        ("do_pivot", do_pivot, torch.bool)):
        if not isinstance(v, torch.Tensor) or v.dim() != 0 or v.dtype != dt:
            raise TypeError(f"{name} must be a 0-d {dt} tensor")
        if v.device != T.device:
            raise ValueError(f"{name} is on {v.device}, T on {T.device}")


def pivot_update_ref(T: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                     do_pivot: torch.Tensor,
                     clamp_rhs: bool = False) -> torch.Tensor:
    """Plain PyTorch pivot on ``(r, s)``, in place; returns ``T``.

    The same arithmetic as ``simplex_tpu/ops/tableau.py::pivot_update``:
    ``prow = T[r] * (1 / T[r, s])`` (RHS lane clamped to ``>= 0`` when
    ``clamp_rhs``), ``T - T[:, s] (outer) prow`` with one rounding per
    element in float32, then row ``r`` becomes ``prow`` and column ``s``
    becomes ``e_r``.
    """
    _check(T, r, s, do_pivot)
    R, W = T.shape
    rr, ss = r.reshape(1), s.reshape(1)
    prow_raw = T.index_select(0, rr)[0]                 # (W,)
    col = T.index_select(1, ss)[:, 0]                   # (R,)
    inv = 1.0 / prow_raw.index_select(0, ss)            # (1,)
    prow = prow_raw * inv
    if clamp_rhs:
        prow = torch.cat([prow[:-1], torch.clamp_min(prow[-1:], 0.0)])
    if T.dtype == torch.float32:
        # Rounded once, as a fused multiply-add (the product of two float32
        # values is exact in float64).  XLA contracts this update into an
        # FMA inside the reference's solve loops, and so does the kernel.
        out = (T.double() - col.double()[:, None]
               * prow.double()[None, :]).to(T.dtype)
    else:
        out = T - col[:, None] * prow[None, :]
    is_r = (torch.arange(R, device=T.device) == r)[:, None]
    is_s = (torch.arange(W, device=T.device) == s)[None, :]
    out = torch.where(is_r, prow[None, :], out)
    out = torch.where(is_s, is_r.to(T.dtype), out)
    T.copy_(torch.where(do_pivot, out, T))
    return T


def pivot_update_(T: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                  do_pivot: torch.Tensor,
                  clamp_rhs: bool = False) -> torch.Tensor:
    """Pivot on ``(r, s)`` in place through K1; returns ``T``.

    A CUDA tensor goes to the kernel (built on first use), a CPU tensor to
    :func:`pivot_update_ref`; any other device raises.
    """
    global LAUNCHES
    _check(T, r, s, do_pivot)
    if T.device.type == "cpu":
        return pivot_update_ref(T, r, s, do_pivot, clamp_rhs)
    if T.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {T.device}")
    from ..runtime import kernels

    lib = kernels.library()
    R, W = T.shape
    col = torch.empty(R, dtype=T.dtype, device=T.device)
    prow = torch.empty(W, dtype=T.dtype, device=T.device)
    vec = 16 // T.element_size()
    vectorized = (W % vec == 0 and T.data_ptr() % 16 == 0
                  and prow.data_ptr() % 16 == 0)
    fn = (lib.k1_pivot_update_f32 if T.dtype == torch.float32
          else lib.k1_pivot_update_f64)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(T.data_ptr(), R, W, r.data_ptr(), s.data_ptr(),
                 do_pivot.data_ptr(), int(bool(clamp_rhs)), col.data_ptr(),
                 prow.data_ptr(), int(vectorized), stream)
    if err != 0:
        raise RuntimeError(f"K1 pivot_update launch failed: CUDA error {err}")
    LAUNCHES += 1
    return T
