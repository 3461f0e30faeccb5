"""``host_s.dense``: seconds per solve of ``solve_lp`` outside its device
loop: equilibration, presolve, the standard form, the float64 finalize and
certificate."""
from lpbench.metrics._common import per_call


def read(record):
    if record["label"] != "dense":
        return None
    call, loop = per_call(record, "call"), per_call(record, "loop")
    return None if call is None or loop is None else call - loop
