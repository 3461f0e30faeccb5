"""``assemble_s.mknap``: host seconds per call in the program's span
``batched.assemble`` (the inputs' host-to-device copy and the bounded
standard form on the card)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "batched.assemble")
