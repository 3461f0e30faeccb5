"""``escalate_s.batch``: host seconds per call in the program's span
``certify.escalate`` (``models/certify.py``: the exact host re-solve of
every instance the float64 check did not certify)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "certify.escalate")
