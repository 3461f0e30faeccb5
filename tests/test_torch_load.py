"""Load tests of the port's web app: ``tests/test_performance_load.py``'s
seven tests on ``simplex_tpu_torch``, with the same users, rounds and
thresholds, on the CPU (the kernels' twins do the pivots).

The concurrent users of the first test submit the three anchors of
``.claude/skills/verify/SKILL.md``, and each page shows the Z that the JAX
app's page shows for the same form.  The reference skips its memory tests
without ``psutil``; these read the resident set from ``/proc/self/status``
(``VmRSS``), so that they run where ``psutil`` is missing too.
"""
import re
import threading
import time

import numpy as np
import pytest

from _torch_parity import ANCHORS, ANCHOR_Z, CPU
from test_torch_web import _form

import simplex_tpu.config as j_config
import simplex_tpu_torch.config as t_config
from simplex_tpu.services.storage import StorageService as JStorage
from simplex_tpu.web.app import init_app as j_init_app
from simplex_tpu.web.microweb import TestClient as JClient
from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.models.batched import BatchedSimplexSolver
from simplex_tpu_torch.services.storage import StorageService
from simplex_tpu_torch.web.app import init_app
from simplex_tpu_torch.web.microweb import TestClient

FORM = {
    "problem_type": "maximize",
    "objective[]": ["3", "5"],
    "constraint_1[]": ["1", "0", "3"],
    "constraint_2[]": ["0", "2", "2"],
    "constraint_sign[]": ["<=", "<=", "<="],
    "constraint_rhs[]": ["4", "12", "18"],
}

_Z_ROW = re.compile(r'<tr class="z-row"><th>Z</th><th>([^<]*)</th></tr>')


@pytest.fixture
def app(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    return init_app(storage=StorageService(str(tmp_path)),
                    solver_config=SolverConfig(device=CPU))


def _rss() -> int:
    """This process's resident set in bytes (``VmRSS``)."""
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS line in /proc/self/status")


def _z(page: str):
    """The Z of a solution page, as the page prints it (None without)."""
    m = _Z_ROW.search(page)
    return m.group(1) if m else None


def _solve_roundtrip(app, form=FORM):
    client = TestClient(app)           # fresh cookie jar per fake user
    t0 = time.perf_counter()
    r1 = client.post("/new", data=form)
    r2 = client.post("/solve")
    elapsed = time.perf_counter() - t0
    ok = (r1.status_code == 200 and r2.status_code == 200
          and "Solucion Factible" in r2.text)
    return ok, elapsed, r2.text


def _users(app, n, form_of=lambda i: FORM):
    """``n`` users on threads, all at once; their results in order."""
    results = [None] * n

    def user(i):
        results[i] = _solve_roundtrip(app, form_of(i))

    threads = [threading.Thread(target=user, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


def test_concurrent_users(app, tmp_path_factory, monkeypatch):
    """10 concurrent fake users on the three anchors; all succeed; mean
    latency < 5 s (reference threshold, test_performance_load.py:100);
    each page's Z is the JAX app's for the same form."""
    forms = [_form(kw) for kw in ANCHORS]
    out = tmp_path_factory.mktemp("jax_app")
    monkeypatch.setattr(j_config, "OUTPUT_DIR", str(out))
    ref_app = j_init_app(storage=JStorage(str(out)))
    ref_z = []
    for form in forms:
        ref = JClient(ref_app)
        ref.post("/new", data=form)
        ref_z.append(_z(ref.post("/solve").text))
    assert ref_z == [f"{z:.4f}" for z in ANCHOR_Z]

    _solve_roundtrip(app)              # warm up first
    results = _users(app, 10, lambda i: forms[i % 3])

    assert all(r is not None for r in results)
    success = sum(1 for ok, _, _ in results if ok)
    mean_latency = sum(dt for _, dt, _ in results) / len(results)
    assert success == 10
    assert mean_latency < 5.0
    assert [_z(page) for _, _, page in results] == [ref_z[i % 3]
                                                    for i in range(10)]


def test_sequential_load_no_degradation(app):
    """30 sequential solves; last-10 mean must stay within 50% of the
    first-10 mean (reference threshold :145)."""
    _solve_roundtrip(app)
    times = []
    for _ in range(30):
        ok, dt, _ = _solve_roundtrip(app)
        assert ok
        times.append(dt)
    first = sum(times[:10]) / 10
    last = sum(times[-10:]) / 10
    assert last < first * 1.5 + 0.05


def test_memory_stays_bounded(app):
    """RSS growth over 20 solves < 500 MB (reference threshold :223)."""
    _solve_roundtrip(app)
    rss0 = _rss()
    for _ in range(20):
        ok, _, _ = _solve_roundtrip(app)
        assert ok
    growth = _rss() - rss0
    assert growth < 500 * 1024 * 1024


def test_error_rate_under_mixed_load(app):
    """Mixed valid/invalid traffic: valid requests must all succeed and
    invalid ones must fail gracefully (flash, not 500)."""
    _solve_roundtrip(app)
    bad_client = TestClient(app)
    errors = 0
    for i in range(12):
        if i % 3 == 2:
            r = bad_client.post(
                "/load", files={"problem_file": ("x.json", "{broken")},
                follow_redirects=True)
            if r.status_code >= 500 or "Archivo JSON inválido" not in r.text:
                errors += 1
        else:
            ok, _, _ = _solve_roundtrip(app)
            if not ok:
                errors += 1
    assert errors == 0


def test_sustained_load_p95(app):
    """Sustained-load tier (reference test_performance_load.py:225-300,
    CI-scaled: 12 s at ~2 users/s instead of 120 s): error rate < 20 %
    and p95 latency < 5 s."""
    _solve_roundtrip(app)              # warm up
    results = []
    lock = threading.Lock()
    threads = []

    def user():
        out = _solve_roundtrip(app)
        with lock:
            results.append(out)

    t_end = time.perf_counter() + 12.0
    while time.perf_counter() < t_end:
        t = threading.Thread(target=user)
        t.start()
        threads.append(t)
        time.sleep(0.5)                # ~2 users/s
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)

    assert len(results) >= 20
    failures = sum(1 for ok, _, _ in results if not ok)
    assert failures / len(results) < 0.20
    lat = sorted(dt for _, dt, _ in results)
    p95 = lat[int(len(lat) * 0.95) - 1]
    assert p95 < 5.0


def test_simultaneous_users_success_rate(app):
    """30 simultaneous threads (reference :149-223): success rate >= 80 %
    and bounded memory growth."""
    _solve_roundtrip(app)
    rss0 = _rss()
    results = _users(app, 30)

    assert all(r is not None for r in results)
    success = sum(1 for ok, _, _ in results if ok)
    assert success / 30 >= 0.80
    growth = _rss() - rss0
    assert growth < 500 * 1024 * 1024


def test_batched_throughput_smoke():
    """Batched-engine throughput sanity: 256 LPs in one call should beat
    256 sequential web solves by a wide margin (the reference's
    pytest-benchmark microbench's role)."""
    rng = np.random.default_rng(0)
    B, m, n = 256, 6, 4
    A = rng.uniform(0.1, 1.0, size=(B, m, n))
    b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    solver = BatchedSimplexSolver(SolverConfig(device=CPU))
    solver.solve_arrays(c, A, b, ops, maximize=True)       # warm up
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True)
    dt = time.perf_counter() - t0
    assert res.n_optimal == B
    assert B / dt > 100            # conservative floor even on CPU
