"""``certify_s.mknap``: host seconds per call in the program's span
``batched.certify`` (a bounded batch: ``certify_uniform_result``, the
bounded float64 KKT check and any escalation on the host, then the reset
of the escalated instances' ``at_upper``)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "batched.certify")
