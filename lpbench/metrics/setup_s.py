"""``setup_s``: from the process's start to the first timed call: imports,
the kernels' build or load, the inputs, the warm calls and their graph
captures (host clock)."""


def read(record):
    return record["setup_s"]
