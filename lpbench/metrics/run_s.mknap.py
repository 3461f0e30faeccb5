"""``run_s.mknap``: host seconds per call in the program's span
``batched.run`` (``models/batched.py::_run_batch``: the bounded loop of
``ops/batched.py`` on K3 in ``runtime/graphs.py``'s graphs, to its host
read and the extraction)."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "batched.run")
