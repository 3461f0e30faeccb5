"""The benchmark of the PyTorch / CUDA port (``simplex_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` (read
by the one generator ``traffic/generate.py``), the program entry the window
drives and the limits of its check in ``workloads/<cell>.json`` and
``entries/<entry>.py``, and each per-layer metric's reader in
``metrics/<metric>.py``.  ``reference/`` is the plain reference that
decides ``correct``; ``roofline/`` the published peaks and the byte counts
of the kernels.  Nothing here imports JAX or the JAX package.
"""
