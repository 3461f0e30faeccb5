"""``escalations.batch``: LPs per call re-solved on the exact host engine,
the solve records' ``escalations`` count (``models/certify.py::
count_escalation``, which also raises ``ESCALATIONS``)."""
from lpbench.metrics._program import count_per_call


def read(record):
    return count_per_call(record, "escalations")
