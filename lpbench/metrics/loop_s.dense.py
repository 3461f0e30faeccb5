"""``loop_s.dense``: host seconds per solve inside
``ops/tableau.py::solve_tableau`` (the graphed device loop to its last
host read), summed over its calls in a solve."""
from lpbench.metrics._common import per_call


def read(record):
    return per_call(record, "loop") if record["label"] == "dense" else None
