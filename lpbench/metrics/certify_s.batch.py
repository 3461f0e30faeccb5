"""``certify_s.batch``: host seconds per call inside
``models/batched.py::certify_uniform_result`` (the float64 KKT check of
every verdict, ``models/certify.py``, and any escalation)."""
from lpbench.metrics._common import per_call


def read(record):
    return per_call(record, "certify")
