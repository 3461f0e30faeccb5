"""The readers of the card's certifier (``certify_device_s.batch``,
``certify_fallback.batch``) on fake solve records: one value per call of
the window, and nothing where the program keeps no records, keeps fewer
than the window's calls, or never certified on the card (a program without
the device certifier)."""
import pytest

from lpbench import registry

NAMES = ("certify_device_s.batch", "certify_fallback.batch")


def _read(name, record):
    return registry.module("metrics", name).read(record)


def _recs(monkeypatch, recs):
    from simplex_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recent", lambda kind=None: recs)


def test_one_value_per_call(monkeypatch):
    record = {"calls": [{"spans": {}}] * 2}
    fake = [{"spans": [("certify.device", "batched.certify", 1.0, 1.004),
                       ("certify.gather", "batched.certify", 1.1, 1.2)],
             "counts": {"certify_fallback": 0}},
            {"spans": [("certify.device", "batched.certify", 2.0, 2.006)],
             "counts": {"certify_fallback": 3, "escalations": 3}}]
    # An older record before the window's is not read.
    _recs(monkeypatch, [{"spans": [("certify.device", None, 0.0, 9.0)],
                         "counts": {"certify_fallback": 50}}] + fake)
    assert _read("certify_device_s.batch", record) == pytest.approx(0.005)
    assert _read("certify_fallback.batch", record) == 1.5


def test_a_program_without_the_device_certifier_says_nothing(monkeypatch):
    record = {"calls": [{"spans": {}}] * 2}
    _recs(monkeypatch, [{"spans": [("certify.lapack", "batched.certify",
                                    1.0, 1.4)],
                         "counts": {"escalations": 1}}] * 2)
    for name in NAMES:
        assert _read(name, record) is None


@pytest.mark.parametrize("name", NAMES)
def test_without_records_the_readers_say_nothing(monkeypatch, name):
    from simplex_tpu_torch.utils import profiling

    record = {"calls": [{"spans": {}}] * 3}
    _recs(monkeypatch, [{"spans": [], "counts": {"certify_fallback": 1}}])
    assert _read(name, record) is None              # fewer than the calls
    monkeypatch.delattr(profiling, "recent")
    assert _read(name, record) is None              # no records at all
