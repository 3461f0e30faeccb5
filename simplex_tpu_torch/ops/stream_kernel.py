"""K4, the streaming copy ``out = x + 1e-7``: CUDA kernel wrapper and its
plain twin.

Port of ``bench.py::_pallas_stream_gbps`` (kernel body ``copy_kernel``):
one read and one write of every element, the measured streaming ceiling
that the pivot rate is held against (``utils/pivot_bench.py``).  It is a
measurement kernel, not a solver step.  ``out`` is ``x`` itself (in place,
the default, as the aliased Pallas call) or a tensor that does not overlap
``x`` (out of place):

* :func:`stream_copy_` launches the hand-written kernel
  (``csrc/stream_copy.cu``) on a CUDA tensor and runs the twin on a CPU
  tensor.  It raises on anything else; there is no fallback from the
  kernel to the twin.
* :func:`stream_copy_ref` is the plain PyTorch twin: the kernel's spec and
  the CPU path.

The constant is rounded to the tensor's type and added with one rounding,
as JAX's weak-typed ``1e-7`` is in the Pallas body, so kernel, twin and
reference agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..runtime import counters

EPS_ADD = 1e-7

# Kernel launches since the counter was last reset to 0.  Incremented only
# where the CUDA kernel is launched, so a run can prove that its streams
# went through the kernel.
LAUNCHES = 0


def _check(x, out):
    """Validate ``x`` and ``out``; returns the output tensor (``x`` when
    ``out`` is None)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a tensor")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError("x must be non-empty")
    if out is None:
        return x
    if not isinstance(out, torch.Tensor):
        raise TypeError("out must be a tensor")
    if out.shape != x.shape or out.dtype != x.dtype \
            or out.device != x.device:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if out.data_ptr() != x.data_ptr():
        nbytes = x.numel() * x.element_size()
        if out.data_ptr() < x.data_ptr() + nbytes \
                and x.data_ptr() < out.data_ptr() + nbytes:
            raise ValueError("out partly overlaps x: pass out=x (in place) "
                             "or a disjoint tensor")
    return out


def stream_copy_ref(x: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch ``out = x + 1e-7``; ``out`` None writes into ``x``.
    Returns ``out``."""
    out = _check(x, out)
    return torch.add(x, EPS_ADD, out=out)


def stream_copy_(x: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = x + 1e-7`` through K4; ``out`` None writes into ``x``.
    Returns ``out``.

    A CUDA tensor goes to the kernel (built on first use), a CPU tensor to
    :func:`stream_copy_ref`; any other device raises.
    """
    out = _check(x, out)
    if x.device.type == "cpu":
        return stream_copy_ref(x, out)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on cuda or cpu tensors, not {x.device}")
    from ..runtime import kernels

    lib = kernels.library()
    fn = (lib.k4_stream_copy_f32 if x.dtype == torch.float32
          else lib.k4_stream_copy_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"K4 stream_copy launch failed: CUDA error {err}")
    counters.add(globals(), "LAUNCHES")
    return out
