"""The port runs on a machine without JAX: it never imports ``jax`` or the
JAX package, directly or indirectly."""
import os
import re
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "simplex_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+simplex_tpu(\.|\s|$)"
    r"|from\s+simplex_tpu(\.|\s))", re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import simplex_tpu_torch, simplex_tpu_torch.cli\n"
            "import simplex_tpu_torch.models.dense\n"
            "import simplex_tpu_torch.controllers.orchestrator\n"
            "import simplex_tpu_torch.runtime.kernels\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'simplex_tpu' or m.startswith('simplex_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_file_imports_jax_or_the_jax_package():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    for m in _FORBIDDEN.finditer(fh.read()):
                        offenders.append((os.path.relpath(path, REPO),
                                          m.group(0).strip()))
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())
