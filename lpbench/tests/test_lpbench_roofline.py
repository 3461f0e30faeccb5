"""The copied byte arithmetic reproduces the bounds of ``chip_smoke.py``."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from lpbench import roofline
from lpbench.tests._tiny import REPO


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_lpbench", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1_bound_at_the_dense_tableau():
    # 2304 x 4608 f32 read and written once: 84.9 MB, 25.35 us.
    nbytes, flops = roofline.k1_pivot_bytes(2304, 4608, 4)
    assert nbytes == 84_934_656
    s, by = roofline.bound_s(nbytes, flops)
    assert by == "bytes" and s * 1e6 == pytest.approx(25.353, abs=1e-3)


def test_peaks_and_bound_are_chip_smokes():
    cs = _chip_smoke()
    assert roofline.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert roofline.F32_FLOPS == cs.F32_FLOPS
    for nbytes, flops in ((84_934_656, 2 * 2304 * 4608), (10, 1e12)):
        s, by = roofline.bound_s(nbytes, flops)
        ms, by2 = cs._bound_ms(nbytes, flops)
        assert (s * 1e3, by) == pytest.approx((ms, by2)) and by == by2


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_step_and_state_bytes_are_chip_smokes(bounded, itemsize):
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(5)
    B, M, N = 257, 32, 128
    for _ in range(5):
        piv = torch.rand(B, generator=g) < 0.6
        flip = (torch.rand(B, generator=g) < 0.2) & ~piv
        opt = (torch.rand(B, generator=g) < 0.3) & ~piv
        bland = torch.rand(B, generator=g) < 0.1
        elig = torch.randint(0, N, (B,), generator=g)
        art = torch.rand(B, generator=g) < 0.5
        for art_rows in (None, art):
            args = (M, N, itemsize, piv, flip, opt, elig, bland)
            mine = roofline.state_bytes(
                *[a.numpy() if torch.is_tensor(a) else a for a in args],
                devex=True, bounded=bounded,
                art_rows=None if art_rows is None else art_rows.numpy())
            theirs = cs._state_bytes(*args, devex=True, bounded=bounded,
                                     art_rows=art_rows)
            assert mine == theirs
            assert (roofline.step_bytes(M, N, itemsize, piv.numpy(),
                                        flip.numpy(), mine)
                    == cs._step_bytes(M, N, itemsize, piv, flip, theirs))


@pytest.mark.parametrize("bounded", [False, True])
def test_a_solve_charges_each_launch_from_the_pivot_counts(bounded):
    cs = _chip_smoke()
    pivots = np.array([0, 3, 7, 7, 12, 1])
    B, M, N, L = len(pivots), 32, 128, 14
    total, flops = roofline.batched_solve_bytes(M, N, 4, pivots, L, bounded)
    want, want_flops = 0, 0
    none = torch.zeros(B, dtype=torch.bool)
    for t in range(L):
        piv = torch.as_tensor(pivots > t)
        st = cs._state_bytes(M, N, 4, piv, none, ~piv,
                             torch.zeros(B, dtype=torch.long), none,
                             devex=True, bounded=bounded)
        want += cs._step_bytes(M, N, 4, piv, none, st)
        want_flops += 2 * M * N * int(piv.sum())
    assert (total, flops) == (want, want_flops)
    # A launch in which every instance stopped moves less than one in
    # which any pivots.
    stop = roofline.batched_solve_bytes(M, N, 4, pivots * 0, 1, bounded)[0]
    one = roofline.batched_solve_bytes(M, N, 4, pivots, 1, bounded)[0]
    assert stop < one


def test_share_reads_nothing_without_device_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 2.0) == 50.0
