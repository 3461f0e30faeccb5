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


def test_importing_the_port_loads_no_jax(tmp_path):
    code = ("import sys\n"
            "import simplex_tpu_torch, simplex_tpu_torch.cli\n"
            "import simplex_tpu_torch.models.dense\n"
            "import simplex_tpu_torch.models.batched\n"
            "import simplex_tpu_torch.models.certify\n"
            "import simplex_tpu_torch.ops.batched\n"
            "import simplex_tpu_torch.ops.batched_kernel\n"
            "import simplex_tpu_torch.controllers.orchestrator\n"
            "import simplex_tpu_torch.runtime.kernels\n"
            "import simplex_tpu_torch.ops.stream_kernel\n"
            "import simplex_tpu_torch.utils.profiling\n"
            "import simplex_tpu_torch.utils.pivot_bench\n"
            "import simplex_tpu_torch.models.revised\n"
            "import simplex_tpu_torch.models.host\n"
            "import simplex_tpu_torch.utils.mps\n"
            "import simplex_tpu_torch.web.app\n"
            "import simplex_tpu_torch.services.pdf\n"
            "import simplex_tpu_torch.controllers.cli_io\n"
            "import simplex_tpu_torch.models.pdhg\n"
            "import simplex_tpu_torch.models.crossover\n"
            "import simplex_tpu_torch.runtime.staging\n"
            "import simplex_tpu_torch.runtime.graphs\n"
            "import simplex_tpu_torch.parallel.sharded\n"
            "import simplex_tpu_torch.parallel.distributed\n"
            "import simplex_tpu_torch.utils.sharded_bench\n"
            "import simplex_tpu_torch.utils.sharded_cards\n"
            "import simplex_tpu_torch.utils.solve_bench\n"
            "import simplex_tpu_torch.utils.sweep_bench\n"
            "import simplex_tpu_torch.bench\n"
            "import simplex_tpu_torch.web_app\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'simplex_tpu' or m.startswith('simplex_tpu.')\n"
            "       or m == 'bench']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    # The WSGI module makes its app when imported: on the CPU here.
    env = dict(os.environ, PYTHONPATH=REPO, SIMPLEX_TPU_DEVICE="cpu",
               SIMPLEX_TPU_OUTPUT_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_wsgi_module_serves_where_its_device_is(tmp_path):
    """``simplex_tpu_torch.web_app`` imported with ``SIMPLEX_TPU_DEVICE=cpu``
    holds a working app at module level; without that variable its device
    is the card, so without a GPU the import raises."""
    form = {"problem_type": "maximize", "objective[]": ["3", "5"],
            "constraint_1[]": ["1", "0", "3"],
            "constraint_2[]": ["0", "2", "2"],
            "constraint_sign[]": ["<=", "<=", "<="],
            "constraint_rhs[]": ["4", "12", "18"]}
    serve = ("from simplex_tpu_torch.web_app import app\n"
             "from simplex_tpu_torch.web.microweb import TestClient\n"
             "c = TestClient(app)\n"
             f"assert c.post('/new', data={form!r}).status_code == 200\n"
             "r = c.post('/solve')\n"
             "assert r.status_code == 200 and 'Solucion Factible' in r.text\n"
             "print('Z', '36.0000' in r.text)\n")
    env = {k: v for k, v in os.environ.items() if k != "SIMPLEX_TPU_DEVICE"}
    env.update(PYTHONPATH=REPO, SIMPLEX_TPU_OUTPUT_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", serve], cwd=REPO,
                         env=dict(env, SIMPLEX_TPU_DEVICE="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "Z True"
    default = ("import torch\n"
               "try:\n"
               "    import simplex_tpu_torch.web_app\n"
               "except RuntimeError as e:\n"
               "    print('raised', torch.cuda.is_available(), e)\n"
               "else:\n"
               "    print('imported', torch.cuda.is_available())\n")
    out = subprocess.run([sys.executable, "-c", default], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    said = out.stdout.strip()
    assert (said.startswith("raised False") and "no CUDA device" in said
            or said == "imported True"), said


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


# The repo-root ``bench.py`` (it imports the JAX package inside its cells).
_ROOT_BENCH = re.compile(r"^\s*(import\s+bench\b|from\s+bench\b)",
                         re.MULTILINE)


def test_no_source_file_imports_the_root_bench_py():
    """The runner ``simplex_tpu_torch/bench.py`` and its cells keep their
    own copies of what they need from the repo's ``bench.py``."""
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if _ROOT_BENCH.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        if _ROOT_BENCH.search(f.read()):
            offenders.append("chip_smoke.py")
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_stream_variants_tool_imports_no_jax():
    """The variant sweep runs on the GPU machine beside chip_smoke.py."""
    path = os.path.join(REPO, "tools", "stream_variants.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_batched_variants_tool_imports_no_jax():
    """The K2/K3 design comparison runs on the GPU machine too."""
    path = os.path.join(REPO, "tools", "batched_variants.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_revised_sizes_tool_imports_no_jax():
    """The revised engine's size probe runs on the GPU machine too."""
    path = os.path.join(REPO, "tools", "revised_sizes.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_sharded_steps_tool_imports_no_jax():
    """The sharded loop's before-and-after probe runs on the GPU machine."""
    path = os.path.join(REPO, "tools", "sharded_steps.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_web_report_tool_imports_no_jax():
    """The netlib-scale web request probe runs on the GPU machine too."""
    path = os.path.join(REPO, "tools", "web_report_size.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())


def test_load_waves_tool_imports_no_jax():
    """The before-and-after waves of concurrent web users run on the GPU
    machine too."""
    path = os.path.join(REPO, "tools", "load_waves.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.search(f.read())
