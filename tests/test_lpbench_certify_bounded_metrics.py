"""The readers of the card's bounded certifier in the ``mknapcb9.relax``
cell (``lpbench/metrics/certify_device_s.mknap.py``,
``certify_fallback.mknap.py``) on fake solve records: one value per call of
the window, and nothing where the program keeps no records, keeps fewer
than the window's calls, or never certified on the card (a program whose
bounded batches the host certifies)."""
import pytest

from lpbench import registry

NAMES = ("certify_device_s.mknap", "certify_fallback.mknap")


def _read(name, record):
    return registry.module("metrics", name).read(record)


def _recs(monkeypatch, recs):
    from simplex_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recent", lambda kind=None: recs)


def test_one_value_per_call(monkeypatch):
    record = {"calls": [{"spans": {}}] * 2}
    fake = [{"spans": [("batched.run", "batched.solve_arrays", 0.0, 1.4),
                       ("certify.device", "batched.certify", 1.5, 1.53)],
             "counts": {"certify_fallback": 0, "bound_flips": 9}},
            {"spans": [("certify.device", "batched.certify", 3.0, 3.05),
                       ("certify.lapack", "batched.certify", 3.05, 3.06)],
             "counts": {"certify_fallback": 1, "escalations": 1}}]
    # A warm call's record before the window's is not read.
    _recs(monkeypatch, [{"spans": [("certify.device", None, 0.0, 9.0)],
                         "counts": {"certify_fallback": 40}}] + fake)
    assert _read("certify_device_s.mknap", record) == pytest.approx(0.04)
    assert _read("certify_fallback.mknap", record) == 0.5


def test_a_program_that_certifies_bounded_batches_on_the_host_says_nothing(
        monkeypatch):
    record = {"calls": [{"spans": {}}] * 2}
    _recs(monkeypatch, [{"spans": [("certify.lapack", "batched.certify",
                                    1.0, 1.6)],
                         "counts": {"at_upper_reset": 0}}] * 2)
    for name in NAMES:
        assert _read(name, record) is None


@pytest.mark.parametrize("name", NAMES)
def test_without_records_the_readers_say_nothing(monkeypatch, name):
    from simplex_tpu_torch.utils import profiling

    record = {"calls": [{"spans": {}}] * 3}
    _recs(monkeypatch, [{"spans": [("certify.device", None, 0.0, 1.0)],
                         "counts": {"certify_fallback": 1}}])
    assert _read(name, record) is None              # fewer than the calls
    monkeypatch.delattr(profiling, "recent")
    assert _read(name, record) is None              # no records at all
