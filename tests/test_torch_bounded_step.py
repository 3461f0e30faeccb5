"""K3, the fused bounded pivot step, at step level: the port against the JAX
reference, and the wrapper's contract.

* K3's twin ``fused_pivot_step_bounded_ref`` is held to the Pallas kernel
  ``simplex_tpu.ops.pallas_batched.fused_pivot_step_bounded`` in interpret
  mode, with and without the artificial-exit rows (``with_art``);
* the port's unfused bounded step (``ops/batched.py::_bounded_step_b``) has
  no standalone counterpart in the reference, which writes it inline in its
  ``backend="xla"`` loops; it is held to snapshots of that loop: both
  packages' ``solve_tableau_batch_bounded(backend="xla", phase2_only=True,
  max_iters=k)`` for k = 1..8;
* crafted instances on the edge of the Harris window show which sums the
  reference rounds once (a fused multiply-add) and that the port rounds the
  same ones.

Each twin case takes eight successive steps from the reference's state on
tableaus that ``compile_batch_uniform(..., ub=)`` builds: phase-1 and
phase-2 instances, every fifth instance not running, Bland's rule off, on
half the instances or on all, and columns at their upper bound after the
first steps.  ``s``, ``r``, the flags, ``basis``, ``at_upper`` and
``is_art_row`` must be equal; ``T``, the Devex weights and ``ub_B`` within
2 ulps (the twin rounds a fused multiply-add through float64).  The CUDA
kernel itself is compared with the twin by the ``gpu`` cases, which run
only on a card and import nothing of JAX:

    python -m pytest tests/test_torch_bounded_step.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

from _torch_parity import MIXED_OPS, random_batch, ulps

from simplex_tpu_torch.models.batched import compile_batch_uniform
from simplex_tpu_torch.ops import batched as tops
from simplex_tpu_torch.ops import batched_kernel as bk

TOL = 1e-6
STEPS = 8
ULPS = 2
NAMES = ("T", "basis", "at_upper", "w", "ub_B", "is_art_row", "s", "r",
         "optimal", "unbounded", "moving")


def _state(seed, mixed, B=12, m=9, n=13, dtype=np.float32, bland="half",
           pad=(8, 128)):
    """Kernel inputs as numpy arrays, from a bounded compiled batch: 60 % of
    the variables bounded, ``ub`` from U(0.5, 6); with ``mixed``, every third
    instance keeps all-``<=`` rows (phase 2) and the others start in phase
    1; every fifth instance is not running.  ``pad``: the compiler's row and
    column padding ((1, 1) leaves the tableau at its own size)."""
    ops = np.full((B, m), -1)
    if mixed:
        ops[np.arange(B) % 3 != 0] = np.resize(MIXED_OPS, m)
    c, A, b, _ = random_batch(seed, B, m, n)
    rng = np.random.default_rng(seed + 100)
    ub = np.where(rng.random((B, n)) < 0.6, rng.uniform(0.5, 6.0, (B, n)),
                  np.inf)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True, dtype=dtype,
                               ub=ub, row_pad=pad[0], col_pad=pad[1])
    zero = np.zeros((B, 1), bool)
    art = np.concatenate([cb.col_mask_p1 & ~cb.col_mask_p2, zero], 1)
    status = np.full(B, -1, np.int32)
    status[::5] = 0
    use_bland = {"off": np.zeros(B, np.int32),
                 "half": (np.arange(B) % 2).astype(np.int32),
                 "on": np.ones(B, np.int32)}[bland]
    return dict(T=cb.T0, basis=cb.basis,
                at_upper=np.zeros(cb.col_mask_p1.shape, bool),
                cm1=np.concatenate([cb.col_mask_p1, zero], 1),
                cm2=np.concatenate([cb.col_mask_p2, zero], 1),
                phase=np.where(cb.need_p1, 1, 2).astype(np.int32),
                status=status, use_bland=use_bland,
                w=np.ones(cb.col_mask_p1.shape, dtype),
                ub=cb.ub_ext,
                ub_B=np.take_along_axis(cb.ub_ext, cb.basis, 1),
                is_art_row=np.take_along_axis(art, cb.basis, 1),
                art=art)


def _torch(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _args(t):
    return (t["T"], t["basis"], t["at_upper"], t["cm1"], t["cm2"], t["phase"],
            t["status"], t["use_bland"], t["w"], t["ub"], t["ub_B"],
            t["is_art_row"], t["art"])


def _assert_step_equal(ref, got, where):
    """``ref`` and ``got``: the eleven outputs of the bounded step, numpy."""
    for name, a, b in zip(NAMES, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            assert ulps(a, b) <= ULPS, f"{name}, {where}"
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{name}, {where}")


def _jax_step(st, devex, with_art):
    import jax.numpy as jnp
    from simplex_tpu.ops.pallas_batched import fused_pivot_step_bounded

    out = fused_pivot_step_bounded(
        jnp.asarray(st["T"]), jnp.asarray(st["basis"]),
        jnp.asarray(st["at_upper"]),
        jnp.asarray(st["cm1"].astype(np.float32)),
        jnp.asarray(st["cm2"].astype(np.float32)), jnp.asarray(st["phase"]),
        jnp.asarray(st["status"]), jnp.asarray(st["use_bland"]),
        jnp.asarray(st["w"]), jnp.asarray(st["ub"]), jnp.asarray(st["ub_B"]),
        jnp.asarray(st["is_art_row"]),
        jnp.asarray(st["art"].astype(np.float32)), tol=TOL, devex=devex,
        interpret=True, with_art=with_art)
    return [np.asarray(x) for x in out]


def _carry(st, out):
    """The state after a step: the reference's outputs."""
    st.update(T=out[0], basis=out[1], at_upper=out[2], w=out[3],
              ub_B=out[4], is_art_row=out[5])


@pytest.mark.parametrize("devex", [False, True])
@pytest.mark.parametrize("bland", ["off", "half", "on"])
@pytest.mark.parametrize("mixed,with_art", [(False, False), (False, True),
                                            (True, True)])
def test_twin_matches_pallas_kernel_interpret(mixed, with_art, bland, devex):
    seed = 3 + 2 * mixed + with_art
    st = _state(seed, mixed, bland=bland)
    moved = at_up = 0
    for step in range(STEPS):
        ref = _jax_step(st, devex, with_art)
        got = bk.fused_pivot_step_bounded_ref(*_args(_torch(st)), tol=TOL,
                                              devex=devex, with_art=with_art)
        _assert_step_equal(ref, [x.numpy() for x in got], f"step {step}")
        moved += int(ref[10].sum())
        at_up += int(ref[2].sum())
        _carry(st, ref)
    assert moved > 0 and at_up > 0     # pivots, and columns at upper
    # Instances that are not running never move.
    first = _state(seed, mixed, bland=bland)
    for k in ("T", "basis", "at_upper"):
        assert np.array_equal(st[k][::5], first[k][::5]), k


def _harris_edge(side, B=256):
    """Instances on the edge of the Harris window of one entering column:
    row 0 limits the step (at its lower bound, or with ``side="hi"`` at its
    upper bound), row 1 has the larger pivot and a ratio exactly at the
    window's edge as one rounding of the relaxed limit
    ``base + tol·(1+|base|)`` puts it, just outside it as the other puts it.
    So the reference picks row 1 iff it rounds that sum once (a fused
    multiply-add).  Returns the tableau, ``ub_B`` and the row each rounding
    picks, as numpy arrays."""
    f32 = np.float32
    tol = f32(TOL)
    rng = np.random.default_rng(17)
    n = 200_000
    dd0 = rng.uniform(0.5, 2.0, n).astype(f32)
    xB0 = rng.uniform(0.0, 5e-6, n).astype(f32)
    u0 = (xB0 + rng.uniform(0.0, 5e-6, n).astype(f32)).astype(f32)
    base = xB0 if side == "lo" else (u0 - xB0).astype(f32)
    one = (f32(1) + np.abs(base)).astype(f32)
    num_fma = (one.astype(np.float64) * np.float64(tol)
               + base.astype(np.float64)).astype(f32)
    num_two = ((one * tol).astype(f32) + base).astype(f32)
    rel_fma, rel_two = (num_fma / dd0).astype(f32), (num_two / dd0).astype(f32)
    k = np.flatnonzero(rel_fma != rel_two)[:B]
    assert len(k) == B
    t1 = np.maximum(rel_fma[k], rel_two[k])
    # Rows 0 and 1 and the objective row; columns: the entering one, the
    # two basic ones, the RHS.
    T = np.zeros((B, 3, 4), f32)
    T[:, 0, 0] = dd0[k] if side == "lo" else -dd0[k]
    T[:, 0, 3] = xB0[k]
    T[:, 1, 0] = 4.0
    T[:, 1, 3] = t1 * f32(4.0)
    T[:, 0, 1] = T[:, 1, 2] = 1.0
    T[:, 2, 0] = -1.0
    ub_B = np.full((B, 2), np.inf, f32)
    if side == "hi":
        ub_B[:, 0] = u0[k]
    return (T, ub_B, (t1 <= rel_fma[k]).astype(np.int32),
            (t1 <= rel_two[k]).astype(np.int32))


@pytest.mark.parametrize("side", ["lo", "hi"])
def test_harris_numerators_round_as_the_pallas_kernel(side):
    """The reference's kernel rounds the lower Harris numerator once and the
    upper one in two steps (XLA contracts the one and not the other); the
    twin follows it on every crafted instance."""
    T, ub_B, r_fma, r_two = _harris_edge(side)
    B = T.shape[0]
    st = dict(T=T, basis=np.tile(np.array([[1, 2]], np.int32), (B, 1)),
              at_upper=np.zeros((B, 3), bool),
              cm1=np.tile(np.array([[True, False, False, False]]), (B, 1)),
              phase=np.full(B, 2, np.int32), status=np.full(B, -1, np.int32),
              use_bland=np.zeros(B, np.int32), w=np.ones((B, 3), np.float32),
              ub=np.full((B, 3), np.inf, np.float32), ub_B=ub_B,
              is_art_row=np.zeros((B, 2), bool), art=np.zeros((B, 4), bool))
    st["cm2"] = st["cm1"]
    ref = _jax_step(st, False, False)
    np.testing.assert_array_equal(ref[7], r_fma if side == "lo" else r_two)
    got = bk.fused_pivot_step_bounded_ref(*_args(_torch(st)), tol=TOL,
                                          with_art=False)
    _assert_step_equal(ref, [x.numpy() for x in got], side)


@pytest.mark.parametrize("side", ["lo", "hi"])
def test_harris_numerators_round_as_the_xla_loop(side):
    """The reference's ``"xla"`` loop rounds both Harris numerators once;
    the port's unfused step follows it: the same leaving row (read from the
    basis after one step) on every crafted instance."""
    import jax.numpy as jnp
    from simplex_tpu.ops import batched as jops

    T, ub_B, r_fma, _ = _harris_edge(side)
    B = T.shape[0]
    basis = np.tile(np.array([[1, 2]], np.int32), (B, 1))
    mask = np.tile(np.array([[True, False, False]]), (B, 1))
    obj = np.zeros((B, 4), np.float32)
    obj[:, 0] = -1.0
    ub = np.full((B, 3), np.inf, np.float32)
    ub[:, 1] = ub_B[:, 0]            # the bound of row 0's basic column
    args = (T, basis, mask, mask, obj, obj, np.zeros(B, bool), ub)
    kw = dict(backend="xla", phase2_only=True, max_iters=1)
    ref = jops.solve_tableau_batch_bounded(*[jnp.asarray(a) for a in args],
                                           **kw)
    got = tops.solve_tableau_batch_bounded(
        *[torch.from_numpy(a) for a in args], **kw)
    left = np.asarray(ref[1])[:, 1] == 0
    np.testing.assert_array_equal(left.astype(np.int32), r_fma)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# name -> (state arguments, devex)
SNAPSHOT_CASES = {"le": (dict(seed=21), False),
                  "le-devex": (dict(seed=22), True)}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
def test_unfused_step_matches_xla_loop_snapshots(case):
    """The unfused bounded step against the reference's ``"xla"`` loop, one
    snapshot a step: ``max_iters=k`` for k = 1..8 with no refactor in
    between.  ``basis``, ``at_upper``, ``status`` and ``pivots`` equal;
    the tableau's lanes left of the RHS within 2 ulps; the RHS column, to
    which the final Newton polish applies a matrix product summed in
    another order, within 1e-5."""
    import jax.numpy as jnp
    from simplex_tpu.models.batched import compile_batch_uniform as j_compile
    from simplex_tpu.ops import batched as jops

    kw, devex = SNAPSHOT_CASES[case]
    c, A, b, ops = random_batch(kw["seed"], B=12, m=9, n=13)
    rng = np.random.default_rng(kw["seed"] + 100)
    ub = np.where(rng.random(c.shape) < 0.6, rng.uniform(0.5, 6.0, c.shape),
                  np.inf)
    cb = j_compile(c, A, b, ops, maximize=True, ub=ub)
    args = (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2, cb.obj_row_p1,
            cb.obj_row_p2, cb.need_p1, cb.ub_ext)
    flips = 0
    for k in range(1, STEPS + 1):
        loop = dict(backend="xla", phase2_only=True, max_iters=k,
                    refactor_every=64, devex=devex)
        ref = [np.asarray(x) for x in jops.solve_tableau_batch_bounded(
            *[jnp.asarray(a) for a in args], **loop)]
        got = tops.solve_tableau_batch_bounded(
            *[torch.from_numpy(np.asarray(a)) for a in args], **loop)
        for name, i in (("basis", 1), ("at_upper", 2), ("status", 3),
                        ("pivots", 5)):
            np.testing.assert_array_equal(got[i].numpy(), ref[i],
                                          err_msg=f"{name}, k={k}")
        assert got[4] == int(ref[4])
        assert ulps(ref[0][:, :, :-1], got[0].numpy()[:, :, :-1]) <= ULPS, k
        np.testing.assert_allclose(got[0].numpy()[:, :, -1], ref[0][:, :, -1],
                                   atol=1e-5, err_msg=f"RHS, k={k}")
        flips = max(flips, int(ref[2].sum()))
    assert flips > 0


@pytest.mark.parametrize("devex", [False, True])
def test_twin_and_unfused_step_agree_in_float64(devex):
    """No JAX reference runs in float64 here (x64 is off), so the two ports
    of the bounded step are held to each other: the same pivots, flips and
    bound state; the same tableaus bit for bit left of the RHS (they round
    alike); the RHS column within 1e-12 (the objective cell is stepped as
    ``z + σ·rc_s·θ`` by the one and as a constraint row by the other)."""
    st = _state(8, True, dtype=np.float64, bland="half")
    p1 = (st["phase"] == 1)[:, None]
    col_mask = torch.from_numpy(np.where(p1, st["cm1"], st["cm2"])[:, :-1])
    t, u = _torch(st), _torch(st)
    for step in range(STEPS):
        got = bk.fused_pivot_step_bounded_ref(*_args(t), tol=1e-9,
                                              devex=devex, with_art=True)
        out = tops._bounded_step_b(
            u["T"], u["basis"], u["at_upper"], col_mask, u["phase"] == 1,
            u["status"] == -1, u["use_bland"] > 0, u["w"], u["ub"], u["ub_B"],
            u["is_art_row"], u["art"], 1e-9, devex, True)
        for k, i in (("T", 0), ("basis", 1), ("at_upper", 2), ("w", 3),
                     ("ub_B", 4), ("is_art_row", 5)):
            u[k] = out[i]
        moving = out[10]
        assert moving.any(), f"step {step}"
        for a, b in zip(out[8:], got[8:]):
            assert torch.equal(a, b), f"step {step}"
        # s and r of an instance that does not move are don't-cares, and
        # the two steps clip them differently.
        for a, b in zip(out[6:8], got[6:8]):
            assert torch.equal(a[moving].to(b.dtype), b[moving])
        for k in ("basis", "at_upper", "ub_B", "is_art_row"):
            assert torch.equal(u[k], t[k]), (k, step)
        assert torch.equal(u["T"][:, :, :-1], t["T"][:, :, :-1])
        torch.testing.assert_close(u["T"][:, :, -1], t["T"][:, :, -1],
                                   rtol=0, atol=1e-12)
        assert torch.equal(u["w"], t["w"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_moving_instances_touch_only_what_they_own(dtype):
    """An instance that neither pivots nor flips stays bit-identical; a
    flip writes only the RHS column and ``at_upper``."""
    st = _state(9, False, dtype=dtype)
    st["status"][:] = -1
    t = _torch(st)
    flipped = pivoted = 0
    for _ in range(STEPS):
        before = {k: v.clone() for k, v in t.items()}
        out = bk.fused_pivot_step_bounded_(*_args(t), devex=True,
                                           with_art=False)
        assert out[0] is t["T"] and out[2] is t["at_upper"]
        assert out[4] is t["ub_B"] and out[5] is t["is_art_row"]
        moving = out[10]
        keep = ~moving
        for k in ("T", "basis", "at_upper", "w", "ub_B", "is_art_row"):
            assert torch.equal(t[k][keep], before[k][keep]), k
        flip = moving & (t["basis"] == before["basis"]).all(1)
        for i in torch.nonzero(flip)[:, 0].tolist():
            flipped += 1
            assert torch.equal(t["T"][i, :, :-1], before["T"][i, :, :-1])
            assert torch.equal(t["w"][i], before["w"][i])
            assert not torch.equal(t["at_upper"][i], before["at_upper"][i])
        pivoted += int((moving & ~flip).sum())
    assert flipped > 0 and pivoted > 0


def test_cpu_tensor_takes_the_twin_and_is_not_counted():
    st = _state(12, True)
    a, b = _torch(st), _torch(st)
    before = bk.LAUNCHES_K3
    out_a = bk.fused_pivot_step_bounded_(*_args(a), devex=True)
    assert bk.LAUNCHES_K3 == before
    out_b = bk.fused_pivot_step_bounded_ref(*_args(b), devex=True)
    for x, y in zip(out_a, out_b):
        assert torch.equal(x, y)


def test_float_masks_and_padded_weights_give_the_same_step():
    """The reference's float masks (set where > 0.5) and (B, N-1) weights,
    padded with an RHS lane of 1, give the step of bool masks and (B, N)
    weights."""
    st = _state(11, True)
    a, b = _torch(st), _torch(st)
    b["w"] = torch.cat([b["w"], torch.ones((b["w"].shape[0], 1))], dim=1)
    for k in ("cm1", "cm2", "art"):
        b[k] = b[k].to(torch.float32)
    out_a = bk.fused_pivot_step_bounded_ref(*_args(a), devex=True)
    out_b = bk.fused_pivot_step_bounded_ref(*_args(b), devex=True)
    assert out_a[3] is a["w"] and out_a[3].shape == a["w"].shape
    assert torch.equal(out_a[3], out_b[3][:, :-1])
    for i, (x, y) in enumerate(zip(out_a, out_b)):
        if i != 3:
            assert torch.equal(x, y), NAMES[i]


def _bad_inputs():
    good = _torch(_state(13, False))
    yield "int tableau", dict(good, T=good["T"].to(torch.int32))
    yield "basis shape", dict(good, basis=good["basis"][:, :-1])
    yield "at_upper dtype", dict(good, at_upper=good["at_upper"].to(
        torch.int32))
    yield "at_upper shape", dict(good, at_upper=good["at_upper"][:, :-1])
    yield "is_art_row dtype", dict(good, is_art_row=good["is_art_row"].to(
        torch.float32))
    yield "ub dtype", dict(good, ub=good["ub"].double())
    yield "ub shape", dict(good, ub=good["ub"][:, :-1])
    yield "ub_B non-contiguous", dict(good, ub_B=good["ub_B"].t().contiguous()
                                      .t())
    yield "art_mask shape", dict(good, art=good["art"][:, :-1])
    yield "ub not a tensor", dict(good, ub=good["ub"].numpy())
    yield "meta device", {k: v.to("meta") for k, v in good.items()}


@pytest.mark.parametrize("name", [n for n, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    kw = dict(_bad_inputs())[name]
    with pytest.raises((TypeError, ValueError)):
        bk.fused_pivot_step_bounded_(*_args(kw), devex=True)


# As tests/test_torch_fused_step.py::GPU_CASES: the main path's shapes,
# tiles above the 64 KB staging budget (streamed; 30 x 500 is the
# mknapcb9.relax cell's 32 x 640 tile), and unpadded tableaus whose
# M*N*sizeof(T) is not a multiple of 16 bytes; mixed batches run the
# artificial-exit rows.
GPU_CASES = [((16, 9, 13), np.float32, True, (8, 128)),
             ((16, 9, 13), np.float64, True, (8, 128)),
             ((64, 30, 50), np.float32, False, (8, 128)),
             ((8, 30, 500), np.float32, False, (8, 128)),
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
    k = {key: v.cuda() for key, v in
         _torch(_state(14, mixed, B=B, m=m, n=n, dtype=dtype,
                       pad=pad)).items()}
    for step in range(STEPS):
        t = {key: v.clone() for key, v in k.items()}
        before = bk.LAUNCHES_K3
        got = bk.fused_pivot_step_bounded_(*_args(k), devex=devex,
                                           with_art=mixed)
        assert bk.LAUNCHES_K3 == before + 1
        ref = bk.fused_pivot_step_bounded_ref(*_args(t), devex=devex,
                                              with_art=mixed)
        torch.cuda.synchronize()
        # Equal, not close: the kernel rounds as its twin does.
        for name, a, b in zip(NAMES, ref, got):
            np.testing.assert_array_equal(b.cpu().numpy(), a.cpu().numpy(),
                                          err_msg=f"{name}, step {step}")
