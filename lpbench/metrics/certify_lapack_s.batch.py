"""``certify_lapack_s.batch``: host seconds per call in the program's
span ``certify.lapack`` (``models/certify.py``: the batched float64
``np.linalg.solve`` pair for the primal and the dual values)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "certify.lapack")
