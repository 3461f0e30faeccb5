"""``solve_s``: the window, to the end of its last solve, over the number
of whole ``solve_lp`` calls in it (host clock)."""


def read(record):
    if record["label"] != "dense" or not record["answers"]:
        return None
    return record["window_s"] / len(record["answers"])
