"""``flips.mknap``: bound flips per call, the solve records' count
``bound_flips`` (``models/batched.py::_run_batch``, from the loop's
per-instance counter): the float32 solve loop's flips.  The float64
finish's steps, flips and pivots together, are the records' count
``finish_steps``, not read here.  None where no record holds the count (a
program whose loop does not count flips)."""
from lpbench.metrics._program import count_per_call, window_records


def read(record):
    recs = window_records(record)
    if recs is None or not any("bound_flips" in r["counts"] for r in recs):
        return None
    return count_per_call(record, "bound_flips")
