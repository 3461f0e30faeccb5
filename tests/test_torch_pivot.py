"""K1, the rank-1 pivot update: the port's twin against the JAX reference,
and the wrapper's contract.

``pivot_update_ref`` is held to ``simplex_tpu.ops.tableau.pivot_update``
(the production form, with and without the RHS clamp) and to the Pallas
kernel ``pivot_update_fused`` in interpret mode, at atol 1e-5 as the JAX
package's own kernel test (tests/test_pallas_batched.py).  The CUDA kernel
itself is compared with the twin by the ``gpu`` case, which runs only on a
card; it imports nothing of JAX, so on a machine with a card and no JAX it
runs alone:

    python -m pytest tests/test_torch_pivot.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

from simplex_tpu_torch.ops import pivot_kernel
from simplex_tpu_torch.ops.pivot_kernel import pivot_update_, pivot_update_ref
from simplex_tpu_torch.runtime import kernels


def _idx(v, device="cpu"):
    return torch.full((), v, dtype=torch.int64, device=device)


def _flag(v, device="cpu"):
    return torch.full((), v, dtype=torch.bool, device=device)


def _tableau(R, W, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(R, W)).astype(np.float32)


def _pivots(R, W):
    return [(0, 0), (R // 3, W // 2), (R - 2, W - 2), (R - 1, W - 1)]


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("shape", [(512, 512), (257, 300)])
def test_twin_matches_jax_pivot_update(shape, clamp):
    import jax.numpy as jnp
    from simplex_tpu.ops.tableau import pivot_update as jax_pivot_update

    R, W = shape
    T_np = _tableau(R, W, seed=R + W)
    T_np[:, -1] = np.abs(T_np[:, -1])
    T_np[5, -1] = -0.25          # a tolerance-negative RHS for the clamp
    basis = jnp.arange(R - 1, dtype=jnp.int32)
    for r, s in _pivots(R, W) + [(5, 7)]:
        ref, _ = jax_pivot_update(jnp.asarray(T_np), basis, jnp.int32(r),
                                  jnp.int32(s), clamp_rhs=clamp)
        got = pivot_update_ref(torch.from_numpy(T_np.copy()), _idx(r),
                               _idx(s), _flag(True), clamp_rhs=clamp)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        # Row r and column s are set, not computed: exact.
        np.testing.assert_array_equal(got.numpy()[:, s],
                                      np.asarray(ref)[:, s])


@pytest.mark.parametrize("shape,block", [((512, 512), (128, 128)),
                                         ((120, 200), (40, 40))])
def test_twin_matches_pallas_kernel_interpret(shape, block):
    import jax.numpy as jnp
    from simplex_tpu.ops.pallas_pivot import pivot_update_fused

    R, W = shape
    T_np = _tableau(R, W, seed=9)
    for r, s in _pivots(R, W):
        ref = pivot_update_fused(jnp.asarray(T_np), r, s, block_r=block[0],
                                 block_c=block[1], interpret=True)
        got = pivot_update_ref(torch.from_numpy(T_np.copy()), _idx(r),
                               _idx(s), _flag(True))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_do_pivot_false_leaves_tableau_bit_identical(dtype):
    T = torch.from_numpy(_tableau(33, 17, seed=1)).to(dtype)
    before = T.clone()
    out = pivot_update_(T, _idx(3), _idx(4), _flag(False), clamp_rhs=True)
    assert out is T
    assert torch.equal(T, before)


def test_cpu_tensor_takes_the_twin_and_is_not_counted():
    T_np = _tableau(40, 24, seed=2)
    T = torch.from_numpy(T_np.copy())
    before = pivot_kernel.LAUNCHES
    pivot_update_(T, _idx(6), _idx(5), _flag(True), clamp_rhs=False)
    assert pivot_kernel.LAUNCHES == before
    ref = pivot_update_ref(torch.from_numpy(T_np.copy()), _idx(6), _idx(5),
                           _flag(True))
    assert torch.equal(T, ref)


def _bad_inputs():
    T = torch.zeros((8, 8))
    good = dict(T=T, r=_idx(1), s=_idx(2), do_pivot=_flag(True))
    yield "int tableau", dict(good, T=torch.zeros((8, 8), dtype=torch.int32))
    yield "1-d tableau", dict(good, T=torch.zeros(8))
    yield "non-contiguous", dict(good, T=torch.zeros((8, 16))[:, ::2])
    yield "int32 index", dict(good, r=torch.full((), 1, dtype=torch.int32))
    yield "1-d index", dict(good, s=torch.ones(1, dtype=torch.int64))
    yield "int flag", dict(good, do_pivot=_idx(1))
    yield "meta device", dict(T=torch.empty((8, 8), device="meta"),
                              r=_idx(1, "meta"), s=_idx(2, "meta"),
                              do_pivot=_flag(True, "meta"))


@pytest.mark.parametrize("name", [n for n, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    kw = dict(_bad_inputs())[name]
    with pytest.raises((TypeError, ValueError)):
        pivot_update_(**kw)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No compiler, no kernel: the build raises rather than falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


@pytest.mark.gpu
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("shape", [(257, 300), (2304, 4608)])
def test_cuda_kernel_matches_twin(shape, clamp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    R, W = shape
    T0 = torch.from_numpy(_tableau(R, W, seed=4)).cuda()
    for r, s in _pivots(R, W):
        got = T0.clone()
        before = pivot_kernel.LAUNCHES
        pivot_update_(got, _idx(r, "cuda"), _idx(s, "cuda"),
                      _flag(True, "cuda"), clamp_rhs=clamp)
        assert pivot_kernel.LAUNCHES == before + 1
        ref = pivot_update_ref(T0.clone(), _idx(r, "cuda"), _idx(s, "cuda"),
                               _flag(True, "cuda"), clamp_rhs=clamp)
        torch.cuda.synchronize()
        tol = 1e-6 * float(T0.abs().max())
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=tol)
        assert torch.equal(got[r], ref[r]) and torch.equal(got[:, s],
                                                           ref[:, s])
    same = T0.clone()
    pivot_update_(same, _idx(1, "cuda"), _idx(2, "cuda"),
                  _flag(False, "cuda"), clamp_rhs=True)
    assert torch.equal(same, T0)


@pytest.mark.gpu
def test_cuda_solve_agrees_with_the_cpu_path():
    """The whole dense solve on the card (every pivot through K1) reaches
    the verdict and objective of the CPU path (the twin)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import simplex_tpu_torch as pt
    from _torch_parity import bench_dense_lp, seeded_lp, z_close

    for kw in [bench_dense_lp(120), seeded_lp(1), seeded_lp(4)]:
        before = pivot_kernel.LAUNCHES
        gpu = pt.solve_lp(pt.LinearProgram(**kw), pt.SolverConfig())
        cpu = pt.solve_lp(pt.LinearProgram(**kw),
                          pt.SolverConfig(device="cpu"))
        assert gpu.status == cpu.status
        if cpu.success:
            assert z_close(cpu.z, gpu.z)
            assert pivot_kernel.LAUNCHES - before >= gpu.nit
