"""K2, the fused batched pivot step, at step level: the port against the JAX
reference, and the wrapper's contract.

* K2's twin ``fused_pivot_step_ref`` is held to the Pallas kernel
  ``simplex_tpu.ops.pallas_batched.fused_pivot_step`` in interpret mode;
* the port's unfused step (``_select_pivot_b`` + ``_devex_update_b`` +
  ``_pivot_update_b``) is held to the same functions of
  ``simplex_tpu.ops.batched``, compiled as one step as the reference's
  loop compiles them.

Each case takes six successive steps from the reference's state on
tableaus that ``compile_batch_uniform`` builds, with phase-1 and phase-2
instances, some instances not running, and Bland's rule off, on half the
instances or on all.  ``s``, ``r``, the flags and ``basis`` must be equal;
``T`` and the Devex weights within 2 ulps (the twin rounds a fused
multiply-add through float64).  The CUDA kernel itself is compared with
the twin by the ``gpu`` case, which runs only on a card and imports nothing
of JAX:

    python -m pytest tests/test_torch_fused_step.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

from _torch_parity import MIXED_OPS, random_batch, ulps

from simplex_tpu_torch.models.batched import compile_batch_uniform
from simplex_tpu_torch.ops import batched as tops
from simplex_tpu_torch.ops import batched_kernel as bk

TOL = 1e-6
STEPS = 6
ULPS = 2


def _state(seed, mixed, B=12, m=9, n=13, dtype=np.float32, bland="half",
           pad=(8, 128)):
    """Kernel inputs as numpy arrays: with ``mixed``, every third instance
    keeps all-``<=`` rows (phase 2) and the others start in phase 1; every
    fifth instance is not running.  ``pad``: the compiler's row and column
    padding ((1, 1) leaves the tableau at its own size)."""
    ops = np.full((B, m), -1)
    if mixed:
        ops[np.arange(B) % 3 != 0] = np.resize(MIXED_OPS, m)
    c, A, b, _ = random_batch(seed, B, m, n)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True, dtype=dtype,
                               row_pad=pad[0], col_pad=pad[1])
    zero = np.zeros((B, 1), bool)
    status = np.full(B, -1, np.int32)
    status[::5] = 0
    use_bland = {"off": np.zeros(B, np.int32),
                 "half": (np.arange(B) % 2).astype(np.int32),
                 "on": np.ones(B, np.int32)}[bland]
    N = cb.T0.shape[2]
    return dict(T=cb.T0, basis=cb.basis,
                cm1=np.concatenate([cb.col_mask_p1, zero], 1),
                cm2=np.concatenate([cb.col_mask_p2, zero], 1),
                phase=np.where(cb.need_p1, 1, 2).astype(np.int32),
                status=status, use_bland=use_bland,
                w=np.ones((B, N - 1), dtype))


def _torch(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _assert_step_equal(ref, got, where):
    """``ref`` and ``got``: (T, basis, w, s, r, optimal, unbounded,
    did_pivot) as numpy arrays."""
    for name, i in (("basis", 1), ("s", 3), ("r", 4), ("optimal", 5),
                    ("unbounded", 6), ("did_pivot", 7)):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(ref[i]),
                                      err_msg=f"{name}, {where}")
    assert ulps(ref[0], got[0]) <= ULPS, f"T, {where}"
    assert ulps(ref[2], got[2]) <= ULPS, f"w, {where}"


@pytest.mark.parametrize("devex", [False, True])
@pytest.mark.parametrize("bland", ["off", "half", "on"])
@pytest.mark.parametrize("mixed", [False, True])
def test_twin_matches_pallas_kernel_interpret(mixed, bland, devex):
    import jax.numpy as jnp
    from simplex_tpu.ops.pallas_batched import fused_pivot_step

    st = _state(3 + mixed, mixed, bland=bland)
    pivoted = 0
    for step in range(STEPS):
        ref = fused_pivot_step(
            jnp.asarray(st["T"]), jnp.asarray(st["basis"]),
            jnp.asarray(st["cm1"].astype(np.float32)),
            jnp.asarray(st["cm2"].astype(np.float32)),
            jnp.asarray(st["phase"]), jnp.asarray(st["status"]),
            jnp.asarray(st["use_bland"]), jnp.asarray(st["w"]), tol=TOL,
            devex=devex, interpret=True)
        ref = [np.asarray(x) for x in ref]
        t = _torch(st)
        got = bk.fused_pivot_step_ref(t["T"], t["basis"], t["cm1"], t["cm2"],
                                      t["phase"], t["status"],
                                      t["use_bland"], t["w"], tol=TOL,
                                      devex=devex)
        _assert_step_equal(ref, [x.numpy() for x in got], f"step {step}")
        pivoted += int(ref[7].sum())
        st.update(T=ref[0], basis=ref[1], w=ref[2])
    assert pivoted > 0
    # Instances that are not running never move.
    assert np.array_equal(st["basis"][::5], _state(3 + mixed, mixed)
                          ["basis"][::5])


def _jax_unfused_step(devex):
    """The reference's unfused loop step, compiled as its loop compiles
    it."""
    import jax
    from simplex_tpu.ops import batched as jops

    @jax.jit
    def step(T, basis, col_mask, use_bland, w, status):
        s, r, optimal, unbounded = jops._select_pivot_b(
            T, basis, col_mask, TOL, use_bland,
            weights=w if devex else None)
        active = (status == -1) & ~optimal & ~unbounded
        if devex:
            w = jops._devex_update_b(w, T, basis, r, s, active)
        T, basis = jops._pivot_update_b(T, basis, r, s, active,
                                        clamp_rhs=True)
        return T, basis, w, s, r, optimal, unbounded, active
    return step


def _torch_unfused_step(T, basis, col_mask, use_bland, w, status, devex):
    s, r, optimal, unbounded = tops._select_pivot_b(
        T, basis, col_mask, TOL, use_bland, weights=w if devex else None)
    active = (status == -1) & ~optimal & ~unbounded
    if devex:
        w = tops._devex_update_b(w, T, basis, r, s, active)
    T, basis = tops._pivot_update_b(T, basis, r, s, active, clamp_rhs=True)
    return T, basis, w, s, r, optimal, unbounded, active


@pytest.mark.parametrize("devex", [False, True])
@pytest.mark.parametrize("bland", ["off", "half", "on"])
@pytest.mark.parametrize("mixed", [False, True])
def test_unfused_step_matches_jax_xla_step(mixed, bland, devex):
    import jax.numpy as jnp

    st = _state(5 + mixed, mixed, bland=bland)
    # Each instance prices with its phase's mask, as the reference's
    # general loop does.
    p1 = (st["phase"] == 1)[:, None]
    col_mask = np.where(p1, st["cm1"], st["cm2"])[:, :-1]
    use_bland = st["use_bland"] > 0
    jstep = _jax_unfused_step(devex)
    for step in range(STEPS):
        ref = jstep(jnp.asarray(st["T"]), jnp.asarray(st["basis"]),
                    jnp.asarray(col_mask), jnp.asarray(use_bland),
                    jnp.asarray(st["w"]), jnp.asarray(st["status"]))
        ref = [np.asarray(x) for x in ref]
        t = _torch(st)
        got = _torch_unfused_step(t["T"], t["basis"],
                                  torch.from_numpy(col_mask),
                                  torch.from_numpy(use_bland), t["w"],
                                  t["status"], devex)
        _assert_step_equal(ref, [x.numpy() for x in got], f"step {step}")
        st.update(T=ref[0], basis=ref[1], w=ref[2])


@pytest.mark.parametrize("devex", [False, True])
def test_twin_and_unfused_step_agree_in_float64(devex):
    """No JAX reference runs in float64 here (x64 is off), so the two
    ports of the step are held to each other: the same pivots; the same
    tableaus bit for bit (they round alike); the same weights as long as
    no Devex reset fires (the twin's reset also reads the RHS lane)."""
    st = _state(8, True, dtype=np.float64, bland="half")
    p1 = (st["phase"] == 1)[:, None]
    col_mask = torch.from_numpy(np.where(p1, st["cm1"], st["cm2"])[:, :-1])
    t = _torch(st)
    u = _torch(st)
    for step in range(STEPS):
        got = bk.fused_pivot_step_ref(t["T"], t["basis"], t["cm1"], t["cm2"],
                                      t["phase"], t["status"],
                                      t["use_bland"], t["w"], tol=1e-9,
                                      devex=devex)
        s, r, optimal, unbounded = tops._select_pivot_b(
            u["T"], u["basis"], col_mask, 1e-9, u["use_bland"] > 0,
            weights=u["w"] if devex else None)
        active = (u["status"] == -1) & ~optimal & ~unbounded
        if devex:
            u["w"] = tops._devex_update_b(u["w"], u["T"], u["basis"], r, s,
                                          active)
        u["T"], u["basis"] = tops._pivot_update_b(u["T"], u["basis"], r, s,
                                                  active, clamp_rhs=True)
        # s and r of an instance that does not pivot are don't-cares, and
        # the two steps clip them differently.
        assert active.any(), f"step {step}"
        for a, b in zip((optimal, unbounded, active), got[5:]):
            assert torch.equal(a, b), f"step {step}"
        for a, b in zip((s, r), got[3:5]):
            assert torch.equal(a[active].to(b.dtype), b[active])
        assert torch.equal(u["T"], t["T"]) and torch.equal(u["basis"],
                                                           t["basis"])
        assert torch.equal(u["w"], t["w"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inactive_instances_stay_bit_identical(dtype):
    st = _state(9, True, dtype=dtype)
    st["status"][:] = 0
    st["status"][1] = -1
    t = _torch(st)
    before = {k: v.clone() for k, v in t.items()}
    out = bk.fused_pivot_step_(t["T"], t["basis"], t["cm1"], t["cm2"],
                               t["phase"], t["status"], t["use_bland"],
                               t["w"], devex=True)
    assert out[0] is t["T"] and out[1] is t["basis"] and out[2] is t["w"]
    did = out[7]
    assert did.tolist() == [i == 1 for i in range(len(did))]
    keep = ~did
    for k in ("T", "basis", "w"):
        assert torch.equal(t[k][keep], before[k][keep]), k
    assert not torch.equal(t["T"][1], before["T"][1])


def test_padded_and_unpadded_weights_give_the_same_step():
    """(B, N-1) weights are padded with an RHS lane of 1, as the reference
    pads them; (B, N) weights are used as they are."""
    st = _state(10, True)
    a, b = _torch(st), _torch(st)
    wide = torch.cat([b["w"], torch.ones((b["w"].shape[0], 1))], dim=1)
    out_a = bk.fused_pivot_step_ref(a["T"], a["basis"], a["cm1"], a["cm2"],
                                    a["phase"], a["status"], a["use_bland"],
                                    a["w"], devex=True)
    out_b = bk.fused_pivot_step_ref(b["T"], b["basis"], b["cm1"], b["cm2"],
                                    b["phase"], b["status"], b["use_bland"],
                                    wide, devex=True)
    assert out_a[2] is a["w"] and out_a[2].shape == a["w"].shape
    assert torch.equal(out_a[0], out_b[0])
    assert torch.equal(out_a[2], out_b[2][:, :-1])
    for x, y in zip(out_a[3:], out_b[3:]):
        assert torch.equal(x, y)


def test_float_masks_and_scalar_bland_are_accepted():
    """The reference's float masks (eligible where > 0.5) and a scalar
    Bland flag, broadcast to every instance, give the step of bool masks
    and a per-instance flag."""
    st = _state(11, False, bland="on")
    a, b = _torch(st), _torch(st)
    out_a = bk.fused_pivot_step_ref(a["T"], a["basis"], a["cm1"], a["cm2"],
                                    a["phase"], a["status"], a["use_bland"],
                                    a["w"])
    out_b = bk.fused_pivot_step_ref(b["T"], b["basis"],
                                    b["cm1"].to(torch.float32),
                                    b["cm2"].to(torch.float32), b["phase"],
                                    b["status"], torch.tensor(1), b["w"])
    assert torch.equal(out_a[0], out_b[0])
    for x, y in zip(out_a[3:], out_b[3:]):
        assert torch.equal(x, y)


def test_cpu_tensor_takes_the_twin_and_is_not_counted():
    st = _state(12, True)
    a, b = _torch(st), _torch(st)
    before = bk.LAUNCHES
    out_a = bk.fused_pivot_step_(a["T"], a["basis"], a["cm1"], a["cm2"],
                                 a["phase"], a["status"], a["use_bland"],
                                 a["w"], devex=True)
    assert bk.LAUNCHES == before
    out_b = bk.fused_pivot_step_ref(b["T"], b["basis"], b["cm1"], b["cm2"],
                                    b["phase"], b["status"], b["use_bland"],
                                    b["w"], devex=True)
    for x, y in zip(out_a, out_b):
        assert torch.equal(x, y)


def _bad_inputs():
    good = _torch(_state(13, False))
    yield "int tableau", dict(good, T=good["T"].to(torch.int32))
    yield "2-d tableau", dict(good, T=good["T"][0])
    yield "non-contiguous", dict(good, T=good["T"].transpose(1, 2))
    yield "int64 basis", dict(good, basis=good["basis"].long())
    yield "basis shape", dict(good, basis=good["basis"][:, :-1])
    yield "mask shape", dict(good, cm1=good["cm1"][:, :-1])
    yield "float phase", dict(good, phase=good["phase"].float())
    yield "weights dtype", dict(good, w=good["w"].double())
    yield "weights shape", dict(good, w=good["w"][:, :-2])
    yield "meta device", {k: v.to("meta") for k, v in good.items()}


@pytest.mark.parametrize("name", [n for n, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    kw = dict(_bad_inputs())[name]
    with pytest.raises((TypeError, ValueError)):
        bk.fused_pivot_step_(kw["T"], kw["basis"], kw["cm1"], kw["cm2"],
                             kw["phase"], kw["status"], kw["use_bland"],
                             kw["w"], devex=True)


# The kernel against its twin on the card: the main path's shapes; tiles
# above the 64 KB staging budget of csrc/batched_step_common.cuh (60x100 in
# float64, 100x150 in float32, 200x300 in float64: the update streams from
# global memory); and unpadded tableaus whose M*N*sizeof(T) is not a
# multiple of 16 bytes, so every instance but the first starts off a
# 16-byte boundary (cp.async staging, scalar head and tail).
GPU_CASES = [((16, 9, 13), np.float32, True, (8, 128)),
             ((16, 9, 13), np.float64, True, (8, 128)),
             ((64, 30, 50), np.float32, True, (8, 128)),
             ((8, 60, 100), np.float32, True, (8, 128)),
             ((8, 60, 100), np.float64, True, (8, 128)),
             ((4, 100, 150), np.float32, True, (8, 128)),
             ((4, 200, 300), np.float64, True, (8, 128)),
             ((16, 8, 12), np.float32, True, (1, 1)),
             ((16, 8, 12), np.float64, True, (1, 1)),
             ((16, 8, 14), np.float32, False, (1, 1))]


def test_gpu_cases_cover_both_paths_and_odd_sizes():
    """The ``gpu`` cases reach both sides of the staging budget and tiles
    that are not a whole number of 16-byte vectors, in both dtypes."""
    seen = set()
    for (B, m, n), dtype, mixed, pad in GPU_CASES:
        T = _state(14, mixed, B=B, m=m, n=n, dtype=dtype, pad=pad)["T"]
        tile = T.shape[1] * T.shape[2] * T.itemsize
        seen.add((np.dtype(dtype).name, tile > 64 * 1024, tile % 16 != 0))
    for dt in ("float32", "float64"):
        assert (dt, True, False) in seen and (dt, False, True) in seen \
            and (dt, False, False) in seen, dt


@pytest.mark.gpu
@pytest.mark.parametrize("devex", [False, True])
@pytest.mark.parametrize("shape,dtype,mixed,pad", GPU_CASES)
def test_cuda_kernel_matches_twin(shape, dtype, mixed, pad, devex):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    B, m, n = shape
    st = _torch(_state(14, mixed, B=B, m=m, n=n, dtype=dtype, pad=pad))
    k = {key: v.cuda() for key, v in st.items()}
    for step in range(STEPS):
        t = {key: v.clone() for key, v in k.items()}
        before = bk.LAUNCHES
        got = bk.fused_pivot_step_(k["T"], k["basis"], k["cm1"], k["cm2"],
                                   k["phase"], k["status"], k["use_bland"],
                                   k["w"], devex=devex)
        assert bk.LAUNCHES == before + 1
        ref = bk.fused_pivot_step_ref(t["T"], t["basis"], t["cm1"], t["cm2"],
                                      t["phase"], t["status"],
                                      t["use_bland"], t["w"], devex=devex)
        torch.cuda.synchronize()
        # Equal, not close: the kernel rounds as its twin does.
        for name, a, b in zip(("T", "basis", "w", "s", "r", "optimal",
                               "unbounded", "did_pivot"), ref, got):
            np.testing.assert_array_equal(b.cpu().numpy(), a.cpu().numpy(),
                                          err_msg=f"{name}, step {step}")
