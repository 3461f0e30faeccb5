"""Uploads that overlap the device's work: pinned buffers, a side stream.

The streaming sweeps (``models/batched.py::solve_arrays_stream`` and
``models/pdhg.py::solve_arrays_stream``) stage batch k+1 while batch k
solves.  The JAX package gets that overlap from asynchronous dispatch; the
port's solve loops read their state back once a chunk, which blocks the
host, so the overlap is made explicit here:

* :func:`stage` copies the host arrays into pinned buffers (on a CUDA
  device only: ``pin_memory`` needs CUDA), issues ``non_blocking`` uploads
  on a side stream and records an event after them;
* :meth:`Staged.tensors` makes the caller's current stream wait on that
  event and marks each tensor as used on that stream (``record_stream``),
  since the caching allocator made them on the side stream.

On the CPU the arrays become tensors at once and there is nothing to wait
for.  The :class:`Staged` object keeps the pinned buffers alive; the caller
drops it once the batch that used it has been solved, after the copy's
event.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class Staged:
    """Device tensors whose upload may still be in flight."""

    def __init__(self, tensors: List[torch.Tensor],
                 pinned: Sequence[torch.Tensor] = (),
                 event: Optional["torch.cuda.Event"] = None):
        self._tensors = tensors
        self._pinned = list(pinned)     # alive until the copies have run
        self._event = event

    def tensors(self) -> List[torch.Tensor]:
        """The tensors, safe to use on the current stream: the stream waits
        for the upload's event first."""
        if self._event is not None:
            current = torch.cuda.current_stream(self._tensors[0].device)
            current.wait_event(self._event)
            for t in self._tensors:
                t.record_stream(current)
            self._event = None
        return self._tensors


def stage(arrays: Sequence[np.ndarray], device: torch.device,
          side_stream: Optional["torch.cuda.Stream"] = None) -> Staged:
    """Upload ``arrays`` (numpy, already in their device dtypes) to
    ``device``.  On a CUDA device the copies run on ``side_stream`` from
    pinned buffers and return at once; elsewhere the tensors are made
    here."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return Staged([h.to(device) for h in host])
    pinned = [h.pin_memory() for h in host]
    event = torch.cuda.Event()
    with torch.cuda.stream(side_stream):
        dev = [p.to(device, non_blocking=True) for p in pinned]
        event.record()
    return Staged(dev, pinned, event)
