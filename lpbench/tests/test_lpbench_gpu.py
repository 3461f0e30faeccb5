"""On the card: the control fails each cell's check at the cell's own size,
and a short run of each cell is correct.  Marked ``gpu``; each test looks
for a card itself and skips without one.  Run on the card with
``python3 -m pytest lpbench/tests/test_lpbench_gpu.py -m gpu``."""
import json
import subprocess
import sys

import pytest
import torch

from lpbench import calibrate, registry
from lpbench.tests import _tiny

CELLS = [w["name"] for w in registry.manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_at_its_own_size(cell, capsys):
    _card()
    calibrate.main(["--workload", cell, "--control-seeds", "17"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = registry.cell(cell, registry.manifest())["workload"]["limits"]
    assert any(line["readings"].get(k, 0) > lim for k, lim in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_the_cell_is_correct(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=_tiny.REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert _tiny.last_json(out.stdout)["correct"] is True
