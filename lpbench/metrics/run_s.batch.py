"""``run_s.batch``: host seconds per call inside
``models/batched.py::_run_batch``: the device loop (``ops/batched.py``,
``runtime/graphs.py``) to its host read and the extraction."""
from lpbench.metrics._common import per_call


def read(record):
    return per_call(record, "run")
