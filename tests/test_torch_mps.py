"""MPS files through the port: ``utils/mps.py``, the MPS branch of
``solve`` with ``--engine auto|dense|revised|host``, and the three engines
on the netlib-feature fixtures, against the JAX package's CLI and engines
(``tests/test_cli.py:117-161``, ``tests/test_mps.py``)."""
import os
import re

import numpy as np
import pytest

from _torch_parity import CPU, bounded_lp, z_close
from test_mps import NLFREE1, TESTPROB, _scipy_ref

import simplex_tpu.config as j_config
import simplex_tpu_torch.config as t_config
from simplex_tpu import cli as j_cli
from simplex_tpu import solve_lp as j_solve_lp
from simplex_tpu.core.problem import LinearProgram as JLP
from simplex_tpu.models.host import HostSimplexSolver as JHost
from simplex_tpu.models.revised import RevisedSimplexSolver as JRevised
from simplex_tpu.utils import mps as j_mps
from simplex_tpu_torch import cli as t_cli
from simplex_tpu_torch import solve_lp as t_solve_lp
from simplex_tpu_torch.config import SolverConfig
from simplex_tpu_torch.core.problem import LinearProgram as TLP
from simplex_tpu_torch.models.host import HostSimplexSolver as THost
from simplex_tpu_torch.models.revised import RevisedSimplexSolver as TRevised
from simplex_tpu_torch.utils import mps as t_mps

FREE_MPS = """NAME FREE1
ROWS
 N  COST
 L  CAP
 E  BAL
COLUMNS
    X1        COST         1.0   CAP          1.0
    X2        COST         2.0   BAL          1.0
    X2        CAP          1.0
    X3        COST        -1.0   BAL         -1.0
RHS
    RHS       CAP          8.0   BAL          1.0
BOUNDS
 FR BND       X3
ENDATA
"""

ONE_ROW_MPS = """NAME T
ROWS
 N  OBJ
 L  R1
COLUMNS
    X1        OBJ         -1.0   R1           1.0
RHS
    RHS       R1           5.0
ENDATA
"""

# Two columns over one row: n >= 2m with no bounds.
TWO_COL_MPS = ONE_ROW_MPS.replace(
    "    X1        OBJ         -1.0   R1           1.0\n",
    "    X1        OBJ         -1.0   R1           1.0\n"
    "    X2        OBJ         -2.0   R1           3.0\n")

MPS_TEXTS = {"free1": FREE_MPS, "one_row": ONE_ROW_MPS,
             "two_col": TWO_COL_MPS, "nlfree1": NLFREE1,
             "testprob": TESTPROB}


@pytest.fixture
def outdir(tmp_path, monkeypatch):
    monkeypatch.setattr(j_config, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(t_config, "OUTPUT_DIR", str(tmp_path))
    monkeypatch.delenv("SIMPLEX_TPU_DEVICE", raising=False)
    return tmp_path


def _result(out):
    """(engine, status, Z) of a printed MPS report."""
    engine = re.search(r"motor (\w+)\)", out).group(1)
    status = int(re.search(r"Estado: (-?\d+)", out).group(1))
    z = re.search(r"Z = (\S+)", out)
    return engine, status, (float(z.group(1)) if z else None)


@pytest.mark.parametrize("name", sorted(MPS_TEXTS))
@pytest.mark.parametrize("engine", ["auto", "dense", "revised", "host"])
def test_cli_mps_report_equals_reference(name, engine, outdir, capsys):
    text = MPS_TEXTS[name]
    path = outdir / "p.mps"
    path.write_text(text)
    rc_ref = j_cli.main(["solve", str(path), "--engine", engine])
    ref = capsys.readouterr().out
    rc = t_cli.main(["solve", str(path), "--engine", engine,
                     "--device", CPU])
    got = capsys.readouterr().out
    assert rc == rc_ref == 0
    e_ref, st_ref, z_ref = _result(ref)
    e_got, st_got, z_got = _result(got)
    assert (e_got, st_got) == (e_ref, st_ref) == (e_ref, 0)
    assert z_close(z_ref, z_got)
    # Everything but the timing line is the same text.
    strip = re.compile(r"tiempo: \S+")
    if engine == "host" or name == "one_row":
        assert strip.sub("", got) == strip.sub("", ref)


def test_auto_engine_choice(outdir, capsys):
    """``auto`` picks revised for finite bounds or n >= 2m, else dense."""
    cases = {"one_row": "dense", "two_col": "revised", "free1": "dense",
             "nlfree1": "revised", "testprob": "revised"}
    for name, engine in cases.items():
        path = outdir / "p.mps"
        path.write_text(MPS_TEXTS[name])
        assert t_cli.main(["solve", str(path), "--device", CPU]) == 0
        assert _result(capsys.readouterr().out)[0] == engine


def test_mps_branch_reads_the_environment(outdir, capsys, monkeypatch):
    """The MPS branch takes its config from ``SolverConfig.from_env()``
    with the device of ``--device`` (the environment's ``cuda`` would
    raise here): a one-pivot cap from the environment stops phase 1 on
    the device and the host engine decides, as in the JAX CLI."""
    path = outdir / "p.mps"
    path.write_text(NLFREE1)
    argv = ["solve", str(path), "--engine", "revised", "--device", CPU]
    strip = re.compile(r"tiempo: \S+")
    assert t_cli.main(argv) == 0
    uncapped = strip.sub("", capsys.readouterr().out)
    monkeypatch.setenv("SIMPLEX_TPU_DEVICE", "cuda")
    monkeypatch.setenv("SIMPLEX_TPU_MAX_ITERS", "1")
    monkeypatch.setenv("SIMPLEX_TPU_PRESOLVE", "0")
    assert t_cli.main(argv) == 0
    got = strip.sub("", capsys.readouterr().out)
    assert j_cli.main(["solve", str(path), "--engine", "revised"]) == 0
    ref = strip.sub("", capsys.readouterr().out)
    assert got == ref != uncapped


def test_unreadable_mps_file(outdir, capsys):
    path = outdir / "bad.mps"
    path.write_text("NAME X\nROWS\n N OBJ\nCOLUMNS\n    X1 OBJ notanumber\n")
    assert t_cli.main(["solve", str(path), "--device", CPU]) == 1
    assert "No se pudo leer" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["dense", "revised"])
def test_device_engines_raise_without_a_gpu(engine, outdir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = outdir / "p.mps"
    path.write_text(NLFREE1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["solve", str(path), "--engine", engine])


def test_nlfree1_parity_dense_revised_host():
    """``tests/test_mps.py::test_nlfree1_parity_dense_revised_host`` on
    the port, each engine held to its JAX counterpart and to HiGHS."""
    j_lp, t_lp = j_mps.parse_mps(NLFREE1), t_mps.parse_mps(NLFREE1)
    ref = _scipy_ref(j_lp)
    assert ref.status == 0
    cfg = SolverConfig(device=CPU)
    pairs = [(j_solve_lp(j_lp), t_solve_lp(t_lp, cfg)),
             (JRevised().solve(j_lp), TRevised(cfg).solve(t_lp)),
             (JHost().solve(j_lp), THost(cfg).solve(t_lp))]
    for r_ref, r in pairs:
        assert r.status == r_ref.status == 0
        assert r.z == pytest.approx(ref.fun, abs=1e-6)
        assert z_close(r_ref.z, r.z)
        assert np.allclose(r.x, ref.x, atol=1e-5)
        assert np.min(r.x) < -0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_netlib_style_revised_matches_reference(seed):
    kw = dict(m=25, n=60)
    j_lp = j_mps.generate_netlib_style(seed, **kw)
    t_lp = t_mps.generate_netlib_style(seed, **kw)
    ref = _scipy_ref(j_lp)
    r_ref = JRevised().solve(j_lp)
    r = TRevised(SolverConfig(device=CPU)).solve(t_lp)
    assert r.status == r_ref.status == ref.status
    if ref.status == 0:
        assert r.z == pytest.approx(ref.fun, rel=1e-5)
        assert z_close(r_ref.z, r.z)


@pytest.mark.parametrize("seed", [3, 4])
def test_netlib_style_free_vars_dense_and_revised(seed):
    """``tests/test_mps.py::test_netlib_style_free_vars_parity`` on the
    port's dense and revised engines."""
    j_lp = j_mps.generate_netlib_style(seed, m=20, n=48, n_free=6)
    t_lp = t_mps.generate_netlib_style(seed, m=20, n=48, n_free=6)
    ref = _scipy_ref(j_lp)
    assert ref.status == 0
    cfg = SolverConfig(device=CPU)
    for r in (t_solve_lp(t_lp, cfg), TRevised(cfg).solve(t_lp)):
        assert r.status == 0
        assert r.z == pytest.approx(ref.fun, rel=1e-5)


def test_host_engine_gives_the_same_results():
    """The port's native library, built from its own copy of the source
    into its own build directory, answers as the JAX package's.  (The one
    test file that builds it on the CPU: two workers building it at once
    would race on the same output file.)"""
    from simplex_tpu_torch.runtime import native

    for seed in range(1, 6):
        kw = bounded_lp(seed)
        a = JHost().solve(JLP(**kw))
        b = THost(SolverConfig(device=CPU)).solve(TLP(**kw))
        assert (a.status, a.nit) == (b.status, b.nit)
        if a.success:
            assert a.z == b.z
            np.testing.assert_array_equal(a.x, b.x)
    here = os.path.dirname(native.__file__)
    assert here.endswith(os.path.join("simplex_tpu_torch", "runtime",
                                      "native"))
    assert os.path.dirname(native._compile()) == os.path.join(here, "build")
