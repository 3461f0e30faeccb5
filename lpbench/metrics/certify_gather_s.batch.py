"""``certify_gather_s.batch``: host seconds per call in the program's
span ``certify.gather`` (``models/certify.py``: the basis matrices gathered
from ``A`` in float64)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "certify.gather")
