#!/usr/bin/env python3
"""Time variants of the streaming pass ``out = x + 1e-7`` on one GPU.

    python3 tools/stream_variants.py [--rounds 5] [--chain 64]

Builds ``tools/stream_variants.cu`` with ``nvcc`` (the port's flags, into
the port's gitignored build directory), checks every variant bit for bit
against ``torch.add(x, 1e-7)`` (in place, out of place and on a view one
element in), then times, in place on float32 arrays of 10241^2 (the
pivot-rate tableau) and 16384 x 32 x 128 (the batched tableau), chains of
``--chain`` launches between two CUDA events: torch's ``add_``, the port's
K4 (``ops/stream_kernel.stream_copy_``) and each variant, all in turns
(forward order in even rounds, backward in odd ones).  Prints, for each,
the median ms a pass over the rounds, its GB/s (one read and one write an
element), the spread ``(max - min) / median`` and the ratio to ``add_`` of
the same round; the card's name and power limit come first and last.
Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SHAPES = [(10241, 10241), (16384, 32, 128)]


def build(kernels):
    """Compile the variants into a shared library; returns it loaded."""
    src = os.path.join(HERE, "stream_variants.cu")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    out = os.path.join(work, "libstream_variants.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    out, src], check=True)
    lib = ctypes.CDLL(out)
    lib.variant_count.restype = ctypes.c_int
    lib.variant_name.restype = ctypes.c_char_p
    lib.variant_name.argtypes = [ctypes.c_int]
    lib.variant_f32.restype = ctypes.c_int
    lib.variant_f32.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--chain", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on a GPU")
    from simplex_tpu_torch.ops import stream_kernel as sk
    from simplex_tpu_torch.runtime import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    lib = build(kernels)
    kernels.library()
    names = [lib.variant_name(i).decode() for i in range(lib.variant_count())]

    def variant(i):
        def run(x, out):
            err = lib.variant_f32(i, x.data_ptr(), out.data_ptr(), x.numel(),
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{names[i]}: CUDA error {err}")
        return run

    entries = [("torch add_", lambda x, out: x.add_(1e-7)),
               ("K4 stream_copy_", lambda x, out: sk.stream_copy_(x))]
    entries += [(name, variant(i)) for i, name in enumerate(names)]

    for shape in SHAPES:
        x = torch.randn(shape, device="cuda")
        ref = torch.add(x, 1e-7)
        flat = x.view(-1)
        view_ref = torch.add(flat[1:], 1e-7)
        for name, fn in entries[2:]:
            got = torch.empty_like(x)
            fn(x, got)
            inplace = x.clone()
            fn(inplace, inplace)
            apart = torch.empty_like(flat[1:])
            fn(flat[1:], apart)
            view = flat.clone()[1:]
            fn(view, view)
            torch.cuda.synchronize()
            ok = (torch.equal(got, ref) and torch.equal(inplace, ref)
                  and torch.equal(apart, view_ref)
                  and torch.equal(view, view_ref))
            if not ok:
                raise RuntimeError(f"{name} differs from torch.add at {shape}")
        nbytes = 2 * x.numel() * x.element_size()
        times = {name: [] for name, _ in entries}
        ratios = {name: [] for name, _ in entries}
        for rnd in range(args.rounds + 1):          # round 0 warms up
            order = entries if rnd % 2 == 0 else entries[::-1]
            this = {}
            for name, fn in order:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.chain):
                    fn(x, x)
                end.record()
                end.synchronize()
                this[name] = start.elapsed_time(end) / args.chain
            if rnd:
                for name in times:
                    times[name].append(this[name])
                    ratios[name].append(this["torch add_"] / this[name])
        label = "x".join(map(str, shape))
        for name, _ in entries:
            ms = statistics.median(times[name])
            spread = (max(times[name]) - min(times[name])) / ms
            print(f"[variant] {label} f32 in place, chains of {args.chain}: "
                  f"{name}: {ms!r} ms a pass, {nbytes / ms / 1e6!r} GB/s, "
                  f"spread {spread!r}, add_/this "
                  f"{statistics.median(ratios[name])!r}", flush=True)
        del x, ref, flat, view_ref
    print(f"[card] {card}", flush=True)


if __name__ == "__main__":
    main()
