"""``certify_check_s.batch``: host seconds per call in the program's
span ``certify.check`` (``models/certify.py``: the primal and dual sign
tests and the certified answers)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "certify.check")
