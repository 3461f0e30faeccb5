"""``certify_device_s.mknap``: host seconds per call in the program's span
``certify.device`` (``models/batched.py::_certify_on_device`` on a bounded
batch: the certifier's inputs to the card, its float64 kernel
``csrc/certify_bounded.cu`` and its verdicts back); None where no call
certified on the card."""
from lpbench.metrics._program import span_per_call


def read(record):
    return span_per_call(record, "certify.device")
