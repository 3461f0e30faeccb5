#!/usr/bin/env python3
"""Time K2 and K3 as they ship against variants of their design, on one GPU.

    python3 tools/batched_variants.py [--rounds 5] [--steps 16] [--B 16384]

Builds ``tools/batched_variants.cu`` with ``nvcc`` (the port's flags, into
the port's gitignored build directory).  Every design is launched straight
through ctypes, so that a chain measures the card and not the host;
"wrapper" is the shipped kernel through its Python wrapper
(``ops/batched_kernel.py``), as the solve loop calls it.  Every variant runs
the shipped per-instance step (``k2_instance`` / ``k3_instance``).  "ring"
runs it on a
persistent grid, as many blocks as are resident on the card, each with a
two-stage ring of staged tiles: instance k+1's TMA copy is in flight while
k decides and writes.  "capped11" and "capped12" (K3 only) keep the shipped
grid but cap K3's registers so that 11 or 12 blocks fit on an SM.  The
kernels as they ship launch one short block an instance and rely on the
other resident blocks to hide a block's decision.

On the bench batches of ``chip_smoke.py`` (``bench_batch`` and
``bench_bounded_batch``: B x (30x50), 32x128 float32, Devex), each design
takes ``--steps`` successive steps from the first tableau; all must end
bit-equal.  Then chains of those steps between two CUDA events are
timed, all designs in turns (forward order in even rounds, backward in odd
ones), one warm-up round and ``--rounds`` timed ones.  Prints, for each,
its registers a thread, the median ms a step, its spread ``(max - min) /
median`` and its time over the shipped one's, round by round; the card's
name and power limit come first and last.  Needs a CUDA card; imports
nothing of JAX.
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def build(kernels):
    """Compile the variant into a shared library; returns it loaded."""
    src = os.path.join(HERE, "batched_variants.cu")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    out = os.path.join(work, "libbatched_variants.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    out, src], check=True)
    lib = ctypes.CDLL(out)
    for name in ("k2_fused_pivot_step_f32", "k2_ring_f32"):
        getattr(lib, name).argtypes = kernels.ARGTYPES[
            "k2_fused_pivot_step_f32"]
    for name in ("k3_fused_pivot_step_bounded_f32", "k3_ring_f32",
                 "k3_capped11_f32", "k3_capped12_f32"):
        getattr(lib, name).argtypes = kernels.ARGTYPES[
            "k3_fused_pivot_step_bounded_f32"]
    lib.ring_grid.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64]
    lib.kernel_registers.argtypes = [ctypes.c_int]
    for name in ("k2_fused_pivot_step_f32", "k2_ring_f32",
                 "k3_fused_pivot_step_bounded_f32", "k3_ring_f32",
                 "k3_capped11_f32", "k3_capped12_f32", "ring_grid",
                 "kernel_registers"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--B", type=int, default=16384)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on a GPU")
    import chip_smoke as cs
    from simplex_tpu_torch.models.batched import compile_batch_uniform
    from simplex_tpu_torch.ops import batched_kernel as bk
    from simplex_tpu_torch.runtime import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    lib = build(kernels)
    kernels.library()
    dev = torch.device("cuda")
    B = args.B
    stream = torch.cuda.current_stream().cuda_stream

    # ---- K2: the classic bench batch ---------------------------------
    cb = compile_batch_uniform(*cs.bench_batch(B), maximize=True)
    T0 = torch.as_tensor(cb.T0, device=dev).contiguous()
    _, M, N = T0.shape
    basis0 = torch.as_tensor(cb.basis, device=dev).contiguous()
    cm = torch.cat([torch.as_tensor(cb.col_mask_p2, device=dev),
                    torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    phase = torch.full((B,), 2, dtype=torch.int32, device=dev)
    status = torch.full((B,), -1, dtype=torch.int32, device=dev)
    bland = torch.zeros((B,), dtype=torch.bool, device=dev)
    T, basis = T0.clone(), basis0.clone()
    w = torch.ones((B, N), device=dev)
    sr = torch.empty((2, B), dtype=torch.int32, device=dev)
    fl = torch.empty((3, B), dtype=torch.bool, device=dev)

    def k2_reset():
        T.copy_(T0)
        basis.copy_(basis0)
        w.fill_(1.0)

    def k2_wrapper():
        bk.fused_pivot_step_(T, basis, cm, cm, phase, status, bland, w,
                             devex=True)

    def k2_variant(fn):
        def run():
            err = fn(T.data_ptr(), B, M, N, basis.data_ptr(), cm.data_ptr(),
                     cm.data_ptr(), phase.data_ptr(), status.data_ptr(),
                     bland.data_ptr(), w.data_ptr(), 1e-6, 1,
                     sr[0].data_ptr(), sr[1].data_ptr(), fl[0].data_ptr(),
                     fl[1].data_ptr(), fl[2].data_ptr(), stream)
            if err:
                raise RuntimeError(f"K2 variant: CUDA error {err}")
        return run

    def k2_state():
        return [T.clone(), basis.clone(), w.clone()]

    # ---- K3: the bounded bench batch -----------------------------------
    c, A, b, ops, ub = cs.bench_bounded_batch(B)
    cb3 = compile_batch_uniform(c, A, b, ops, maximize=True, ub=ub)
    first = cs.BoundedState(torch, cb3, status.clone(), bland.clone())
    st = first.clone()

    def k3_reset():
        for name in cs.BoundedState.STATE:
            getattr(st, name).copy_(getattr(first, name))

    def k3_wrapper():
        bk.fused_pivot_step_bounded_(*st.args(), devex=True, with_art=False)

    art = st.art

    def k3_variant(fn):
        def run():
            err = fn(st.T.data_ptr(), B, M, N, st.basis.data_ptr(),
                     st.at_upper.data_ptr(), st.cm1.data_ptr(),
                     st.cm2.data_ptr(), st.phase.data_ptr(),
                     st.status.data_ptr(), st.bland.data_ptr(),
                     st.w.data_ptr(), st.ub.data_ptr(), st.ub_B.data_ptr(),
                     st.is_art_row.data_ptr(), art.data_ptr(), 1e-6, 1, 0,
                     sr[0].data_ptr(), sr[1].data_ptr(), fl[0].data_ptr(),
                     fl[1].data_ptr(), fl[2].data_ptr(), stream)
            if err:
                raise RuntimeError(f"K3 variant: CUDA error {err}")
        return run

    def k3_state():
        return [getattr(st, name).clone() for name in cs.BoundedState.STATE]

    grid = {0: lib.ring_grid(0, B, M, N), 1: lib.ring_grid(1, B, M, N)}
    regs = [lib.kernel_registers(i) for i in range(6)]
    suites = (
        ("K2", k2_reset, k2_state, 0,
         {"shipped": (k2_variant(lib.k2_fused_pivot_step_f32), regs[0]),
          "wrapper": (k2_wrapper, regs[0]),
          "ring": (k2_variant(lib.k2_ring_f32), regs[2])}),
        ("K3", k3_reset, k3_state, 1,
         {"shipped": (k3_variant(lib.k3_fused_pivot_step_bounded_f32),
                      regs[1]),
          "wrapper": (k3_wrapper, regs[1]),
          "ring": (k3_variant(lib.k3_ring_f32), regs[3]),
          "capped11": (k3_variant(lib.k3_capped11_f32), regs[4]),
          "capped12": (k3_variant(lib.k3_capped12_f32), regs[5])}))
    for name, reset, state, bounded, designs in suites:
        # Every design takes the same steps, bit for bit.
        outs = {}
        for which, (fn, _) in designs.items():
            reset()
            for _ in range(args.steps):
                fn()
            torch.cuda.synchronize()
            outs[which] = state()
        for which, out in outs.items():
            for x, y in zip(outs["shipped"], out):
                if not torch.equal(x, y):
                    raise SystemExit(f"{name}: {which} differs from the "
                                     f"shipped kernel")
        times = {which: [] for which in designs}
        for rnd in range(args.rounds + 1):
            order = list(designs) if rnd % 2 == 0 else list(designs)[::-1]
            for which in order:
                fn = designs[which][0]
                reset()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.steps):
                    fn()
                end.record()
                end.synchronize()
                if rnd:
                    times[which].append(start.elapsed_time(end) / args.steps)
        for which, ts in times.items():
            med = statistics.median(ts)
            ratio = [t / s0 for t, s0 in zip(ts, times["shipped"])]
            how = (f"persistent grid of {grid[bounded]} blocks"
                   if which == "ring" else "one block an instance")
            print(f"[{name}] B={B} {M}x{N} f32 Devex, {args.steps} steps "
                  f"from the first tableau: {which} ({how}, "
                  f"{designs[which][1]} registers) {med!r} ms a step "
                  f"(spread {(max(ts) - min(ts)) / med!r}; rounds {ts!r}); "
                  f"over shipped, per round: median "
                  f"{statistics.median(ratio)!r} {ratio!r}", flush=True)
        print(f"[{name}] every design bit-equal after {args.steps} steps",
              flush=True)
    print(f"[card] {card}", flush=True)


if __name__ == "__main__":
    main()
