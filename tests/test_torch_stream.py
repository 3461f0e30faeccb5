"""K4, the streaming copy, and the pivot-rate measurement path: the port's
twin against the Pallas copy of ``bench.py::_pallas_stream_gbps``, the
wrapper's contract, and ``utils/pivot_bench.bench_pivot_update``'s chained
pivots against bench.py's jitted ``lax.scan``.

The Pallas kernel is a closure inside ``_pallas_stream_gbps``, so the test
rebuilds the same ``pallas_call`` (``bench.py:262-289``: the body, the
row-block picker and map, aliased and not) without the TPU-only memory
spaces and compiler parameters, and runs it in interpret mode.  The CUDA
kernel itself is compared with the twin by the ``gpu`` cases, which run
only on a card; they import nothing of JAX:

    python -m pytest tests/test_torch_stream.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

from simplex_tpu_torch.ops import pivot_kernel, stream_kernel
from simplex_tpu_torch.ops.stream_kernel import stream_copy_, stream_copy_ref
from simplex_tpu_torch.utils import pivot_bench
from simplex_tpu_torch.utils.pivot_bench import (
    bench_pivot_update,
    hbm_peak,
    k4_stream_gbps,
    median_time,
    pivot_problem,
)


def _data(shape, seed, dtype=np.float32):
    """Normal values over many scales, down to the constant's own size,
    so the add rounds in every way it can."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-9, 4, size=shape)
    return (rng.normal(size=shape) * scale).astype(dtype)


def _pallas_copy(M, N, inplace):
    """``bench.py:262-289``'s copy kernel for an (M, N) f32 array."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    blk = 64
    for cand in range(448, 8, -8):
        if M % cand == 0:
            blk = cand
            break

    def copy_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1e-7

    return pl.pallas_call(
        copy_kernel,
        grid=(M // blk,),
        in_specs=[pl.BlockSpec((blk, N), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((blk, N), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        input_output_aliases=({0: 0} if inplace else {}),
        interpret=True,
    )


@pytest.mark.parametrize("inplace", [True, False])
@pytest.mark.parametrize("shape", [(64, 128), (512, 128), (576, 256)])
def test_twin_equals_pallas_copy_interpret(shape, inplace):
    """Three passes chained in a jitted ``lax.scan``, as bench.py runs the
    kernel, against three twin passes: equal bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    copy = _pallas_copy(*shape, inplace)

    @jax.jit
    def run(T):
        T, _ = lax.scan(lambda T, _: (copy(T), None), T, None, length=3)
        return T

    x_np = _data(shape, seed=shape[0])
    ref = np.asarray(run(jnp.asarray(x_np)))
    x = torch.from_numpy(x_np.copy())
    if inplace:
        for _ in range(3):
            stream_copy_ref(x)
        got = x
    else:
        got, buf = torch.empty_like(x), torch.empty_like(x)
        stream_copy_ref(x, out=buf)
        stream_copy_ref(buf, out=got)
        stream_copy_ref(got, out=buf)
        got = buf
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, x_np)


@pytest.mark.parametrize("inplace", [True, False])
def test_twin_float64_equals_numpy(inplace):
    x_np = _data((37, 53), seed=5, dtype=np.float64)
    x = torch.from_numpy(x_np.copy())
    out = stream_copy_ref(x, out=None if inplace else torch.empty_like(x))
    assert (out is x) == inplace
    np.testing.assert_array_equal(out.numpy(), x_np + 1e-7)
    if not inplace:
        np.testing.assert_array_equal(x.numpy(), x_np)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensor_takes_the_twin_and_is_not_counted(dtype, monkeypatch):
    monkeypatch.setattr(stream_kernel, "LAUNCHES", 0)
    x0 = torch.from_numpy(_data((40, 24), seed=2)).to(dtype)
    ref = stream_copy_ref(x0.clone())
    x = x0.clone()
    assert stream_copy_(x) is x
    out = torch.empty_like(x0)
    assert stream_copy_(x0, out=out) is out
    assert stream_kernel.LAUNCHES == 0
    assert torch.equal(x, ref) and torch.equal(out, ref)


def test_misaligned_view_and_disjoint_views_of_one_buffer():
    """A view one element in (what the kernel's scalar head serves) and
    two disjoint halves of one buffer are taken."""
    buf = torch.from_numpy(_data((2 * 257 * 300 + 1,), seed=3))
    view = buf[1:257 * 300 + 1]
    ref = stream_copy_ref(view.clone())
    stream_copy_(view)
    assert torch.equal(view, ref)
    lo, hi = buf[:1000], buf[1000:2000]
    ref = stream_copy_ref(lo.clone())
    stream_copy_(lo, out=hi)
    assert torch.equal(hi, ref)


def _bad_inputs():
    x = torch.zeros((8, 8))
    buf = torch.zeros(96)
    yield "int tensor", dict(x=torch.zeros((8, 8), dtype=torch.int32))
    yield "float16 tensor", dict(x=torch.zeros((8, 8), dtype=torch.float16))
    yield "not a tensor", dict(x=np.zeros((8, 8), np.float32))
    yield "empty", dict(x=torch.zeros((0, 8)))
    yield "non-contiguous x", dict(x=torch.zeros((8, 16))[:, ::2])
    yield "non-contiguous out", dict(x=x, out=torch.zeros((8, 16))[:, ::2])
    yield "out shape", dict(x=x, out=torch.zeros((8, 9)))
    yield "out dtype", dict(x=x, out=torch.zeros((8, 8), dtype=torch.float64))
    yield "out device", dict(x=x, out=torch.empty((8, 8), device="meta"))
    yield "meta device", dict(x=torch.empty((8, 8), device="meta"))
    yield "partial overlap", dict(x=buf[:64].view(8, 8),
                                  out=buf[32:].view(8, 8))
    yield "overlap one element", dict(x=buf[:48], out=buf[47:95])


@pytest.mark.parametrize("name", [n for n, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    kw = dict(_bad_inputs())[name]
    with pytest.raises((TypeError, ValueError)):
        stream_copy_(**kw)
    if name != "meta device":      # the twin runs wherever torch.add does
        with pytest.raises((TypeError, ValueError)):
            stream_copy_ref(**kw)


def _jax_pivot_chain(T_np, rs_np):
    """bench.py:95-108: the tableau and positions from the same seeds,
    ``iters`` pivots in one jitted ``lax.scan``; returns (T, basis)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from simplex_tpu.ops.tableau import pivot_update

    @jax.jit
    def run(T, basis, rs):
        def body(carry, rc):
            T, basis = carry
            return pivot_update(T, basis, rc[0], rc[1]), None
        (T, basis), _ = lax.scan(body, (T, basis), rs)
        return T, basis

    m = T_np.shape[0] - 1
    T, basis = run(jnp.asarray(T_np), jnp.arange(m, dtype=jnp.int32),
                   jnp.asarray(rs_np.astype(np.int32)))
    return np.asarray(T), np.asarray(basis)


@pytest.mark.parametrize("iters", [3, 8])
def test_bench_pivot_chain_matches_jax_scan(iters):
    """The chained pivots leave the tableau and basis of bench.py's scan:
    the tableau within 1e-5·max|T| (XLA contracts the update into an FMA
    inside the scan; the twin rounds once too, through float64, which can
    differ in the last bit), the basis equal.  From the fourth pivot on,
    seed 1 pivots a column already made a unit column at this size, so the
    8-pivot chain ends mostly NaN in both; where it does, the NaN pattern
    must be equal.  The 3-pivot chain stays finite."""
    size = 48
    T_np = np.random.default_rng(0).normal(size=(size + 1, size + 1)) \
        .astype(np.float32)
    rs_np = np.random.default_rng(1).integers(0, size, size=(iters, 2))
    got_T, got_rs = pivot_problem(size, iters)
    np.testing.assert_array_equal(got_T, T_np)
    np.testing.assert_array_equal(got_rs, rs_np)

    out = bench_pivot_update(size=size, iters=iters, reps=2, device="cpu",
                             with_batched=False)
    T_ref, basis_ref = _jax_pivot_chain(T_np, rs_np)
    T = out["tableau"].numpy()
    np.testing.assert_array_equal(np.isnan(T), np.isnan(T_ref))
    finite = np.isfinite(T_ref)
    if iters == 3:
        assert finite.all()
    tmax = np.abs(T_ref[finite]).max()
    np.testing.assert_allclose(T[finite], T_ref[finite], rtol=0,
                               atol=1e-5 * tmax)
    np.testing.assert_array_equal(out["basis"].numpy(), basis_ref)


DETAIL_KEYS = {
    "per_pivot_ms", "achieved_GBps", "hbm_peak_GBps", "frac_of_hbm_peak",
    "empirical_stream_GBps", "xla_outofplace_GBps", "k4_stream_GBps",
    "k4_outofplace_GBps", "ceiling_GBps", "n_reps", "pivot_spread",
    "stream_spread", "outofplace_spread", "k4_stream_spread",
    "k4_outofplace_spread", "device",
}


def test_bench_pivot_update_returns_the_documented_record(monkeypatch):
    monkeypatch.setattr(pivot_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(stream_kernel, "LAUNCHES", 0)
    out = bench_pivot_update(size=32, iters=4, reps=2, device="cpu",
                             with_batched=False)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail",
                        "tableau", "basis"}
    assert out["metric"] == "pivots_per_sec_32x32_f32"
    d = out["detail"]
    assert set(d) == DETAIL_KEYS
    assert d["device"] == "cpu" and d["n_reps"] == 2
    assert d["hbm_peak_GBps"] is None and d["frac_of_hbm_peak"] is None
    assert d["ceiling_GBps"] == max(d["empirical_stream_GBps"],
                                    d["k4_stream_GBps"])
    assert out["vs_baseline"] == pytest.approx(d["achieved_GBps"]
                                               / d["ceiling_GBps"])
    assert out["value"] == pytest.approx(1e3 / d["per_pivot_ms"])
    assert out["tableau"].shape == (33, 33) and out["basis"].shape == (32,)
    # On the CPU the twins run: nothing counts as a launch.
    assert pivot_kernel.LAUNCHES == 0 and stream_kernel.LAUNCHES == 0


def test_hbm_peak_and_median_time_on_the_cpu():
    assert hbm_peak("cpu") is None
    calls = []
    med, spread = median_time(lambda: calls.append("run"), reps=3,
                              device="cpu",
                              setup=lambda: calls.append("setup"))
    assert calls == ["setup", "run"] * 3
    assert med >= 0.0 and spread >= 0.0


@pytest.mark.parametrize("inplace", [True, False])
def test_k4_stream_gbps_leaves_its_input_and_counts_no_launch(
        inplace, monkeypatch):
    monkeypatch.setattr(stream_kernel, "LAUNCHES", 0)
    T = torch.from_numpy(_data((33, 65), seed=6))
    before = T.clone()
    gbps, spread = k4_stream_gbps(T, iters=4, reps=2, inplace=inplace)
    assert gbps > 0.0 and spread >= 0.0
    assert torch.equal(T, before)
    assert stream_kernel.LAUNCHES == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_twin(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for shape in [(257, 300), (1031, 4099), (64, 32, 128)]:
        x0 = torch.from_numpy(_data(shape, seed=7)).to(dtype).cuda()
        ref = stream_copy_ref(x0.clone())
        before = stream_kernel.LAUNCHES
        got = stream_copy_(x0.clone())
        out = stream_copy_(x0, out=torch.empty_like(x0))
        assert stream_kernel.LAUNCHES == before + 2
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(out, ref)
        flat = x0.clone().view(-1)
        view = flat[1:]
        ref = stream_copy_ref(view.clone())
        apart = stream_copy_(view, out=torch.empty_like(view))
        stream_copy_(view)
        torch.cuda.synchronize()
        assert torch.equal(view, ref) and torch.equal(apart, ref)
        assert torch.equal(flat[:1], x0.view(-1)[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_at_lengths_of_partial_tiles(dtype):
    """Lengths that end inside a block's tile (1024 vectors of 16 bytes)
    and inside a vector, from the buffer's start and one element in: the
    last tile's missing vectors and the scalar tail must be handled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    for n in [3 * 1024 * vec + 37 * vec + 3, 1024 * vec - 1, 5, 1]:
        buf = torch.from_numpy(_data((n + 1,), seed=n)).to(dtype).cuda()
        for x in (buf[:n], buf[1:]):
            ref = stream_copy_ref(x.clone())
            out = stream_copy_(x, out=torch.empty_like(x))
            stream_copy_(x)
            torch.cuda.synchronize()
            assert torch.equal(out, ref) and torch.equal(x, ref)


@pytest.mark.gpu
def test_cuda_pivot_bench_goes_through_k1_and_k4():
    """A small chain on the card: K1 and K4 launched, the state within
    1e-5·max|T| of the CPU run's (K1 rounds with one FMA, the twin through
    float64), the basis equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    k1, k4 = pivot_kernel.LAUNCHES, stream_kernel.LAUNCHES
    gpu = bench_pivot_update(size=256, iters=3, reps=2, with_batched=False)
    assert pivot_kernel.LAUNCHES - k1 == 3 * 3
    assert stream_kernel.LAUNCHES - k4 == 2 * 3 * 3
    cpu = bench_pivot_update(size=256, iters=3, reps=2, device="cpu",
                             with_batched=False)
    T_ref = cpu["tableau"]
    torch.testing.assert_close(gpu["tableau"].cpu(), T_ref, rtol=0,
                               atol=1e-5 * float(T_ref.abs().max()))
    assert torch.equal(gpu["basis"].cpu(), cpu["basis"])
    assert gpu["detail"]["device"] == torch.cuda.get_device_name(0)
