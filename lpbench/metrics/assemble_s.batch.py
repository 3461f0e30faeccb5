"""``assemble_s.batch``: host seconds per call in the program's span
``batched.assemble`` (``models/batched.py::compile_batch_on_device``: the
inputs' host-to-device copy and the standard form on the card)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "batched.assemble")
