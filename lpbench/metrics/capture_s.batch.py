"""``capture_s.batch``: host seconds of the process in the program's span
``graphs.capture`` (``runtime/graphs.py``: each new chunk variant's CUDA
graph capture, without the eager warm-up before it, where a new process
builds its kernels), all of them in set-up: the window captures none."""
from lpbench.metrics._program import span_total


def read(record):
    return span_total("graphs.capture")
