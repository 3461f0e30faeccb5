"""``certify_fallback.mknap``: LPs per call that the card's bounded
certifier left uncertified and handed to the host copy
(``models/batched.py::_certify_on_device``), the solve records'
``certify_fallback`` count; None where no call certified on the card (no
record holds the count)."""
from lpbench.metrics._program import count_per_call, window_records


def read(record):
    recs = window_records(record)
    if recs is None or not any("certify_fallback" in r["counts"]
                               for r in recs):
        return None
    return count_per_call(record, "certify_fallback")
