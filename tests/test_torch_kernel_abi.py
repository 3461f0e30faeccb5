"""The C interface of the port's CUDA kernels against its ctypes table.

Every ``extern "C"`` function in ``simplex_tpu_torch/csrc/*.cu`` is parsed
from the source, and ``runtime/kernels.ARGTYPES`` must declare it with the
same number of arguments, each of the matching kind (pointer, int64,
uint64, int, float, double).  ctypes passes what it is told, so a
mismatch would cut a pointer or shift every later argument on the card;
here, where there is no ``nvcc``, this is what catches an interface change.
"""
import ctypes
import os
import re

import pytest

from simplex_tpu_torch.runtime import kernels

_EXTERN = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)

# A C parameter's type (the name stripped) -> its kind.
_SCALARS = {"int64_t": "int64", "uint64_t": "uint64", "int": "int",
            "int32_t": "int", "float": "float", "double": "double"}

# A ctypes type -> the same kinds.
_CTYPES = {ctypes.c_void_p: "pointer", ctypes.c_int64: "int64",
           ctypes.c_uint64: "uint64", ctypes.c_int: "int",
           ctypes.c_float: "float", ctypes.c_double: "double"}


def _kind(param):
    """The kind of one C parameter, e.g. ``const uint8_t* cm1``."""
    text = " ".join(param.split())
    if "*" in text:
        return "pointer"
    words = [w for w in text.split(" ") if w != "const"]
    assert len(words) == 2, f"cannot read parameter {param!r}"
    assert words[0] in _SCALARS, f"unknown C type in {param!r}"
    return _SCALARS[words[0]]


def _entry_points():
    """{name: (return type, [kinds])} of every csrc/*.cu source."""
    out = {}
    for fname in sorted(os.listdir(kernels.CSRC_DIR)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(kernels.CSRC_DIR, fname),
                  encoding="utf-8") as f:
            text = f.read()
        for ret, name, params in _EXTERN.findall(text):
            assert name not in out, f"{name} defined twice"
            out[name] = (ret, [_kind(p) for p in params.split(",")])
    return out


ENTRY_POINTS = _entry_points()


def test_every_source_entry_point_is_declared_and_no_other():
    assert ENTRY_POINTS, "no extern \"C\" function found in csrc/*.cu"
    assert sorted(ENTRY_POINTS) == sorted(kernels.ARGTYPES)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_argtypes_match_the_c_signature(name):
    ret, kinds = ENTRY_POINTS[name]
    assert ret == "int", f"{name} returns {ret}, the wrappers read an int"
    declared = [_CTYPES[t] for t in kernels.ARGTYPES[name]]
    assert len(declared) == len(kinds), (
        f"{name}: {len(kinds)} C arguments, {len(declared)} declared")
    assert declared == kinds, f"{name}: C {kinds}, ctypes {declared}"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_entry_point_ends_with_the_stream(name):
    """Each kernel launches on the caller's stream, passed last (the graph
    reader ``graph_node_counts`` enqueues nothing: its last argument is its
    output array; ``graph_stream_create``'s is where it writes the stream
    it made)."""
    assert ENTRY_POINTS[name][1][-1] == "pointer"


def test_graph_node_counts_reads_one_graph_into_an_array():
    """A ``cudaGraph_t`` (a ``uint64``), the array's length, the array."""
    assert ENTRY_POINTS["graph_node_counts"] == (
        "int", ["uint64", "int64", "pointer"])


def test_graph_stream_create_writes_one_stream():
    """One argument: where the new stream's handle goes."""
    assert ENTRY_POINTS["graph_stream_create"] == ("int", ["pointer"])


def test_batched_steps_take_no_scratch():
    """K2 and K3 keep their pivot column and row in shared memory: their
    pointer arguments are the tableau, the state and the outputs alone."""
    for name, n_args in (("k2_fused_pivot_step_f32", 19),
                         ("k2_fused_pivot_step_f64", 19),
                         ("k3_fused_pivot_step_bounded_f32", 25),
                         ("k3_fused_pivot_step_bounded_f64", 25)):
        assert len(ENTRY_POINTS[name][1]) == n_args, name


@pytest.mark.parametrize("param,kind", [
    ("float* tab", "pointer"), ("const uint8_t* cm1", "pointer"),
    ("void* stream", "pointer"), ("int64_t B", "int64"),
    ("uint64_t magic", "uint64"), ("int devex", "int"),
    ("float tol", "float"), ("double tol", "double"),
    ("const double*\n    ub", "pointer")])
def test_parameter_kinds_are_read_from_the_text(param, kind):
    assert _kind(param) == kind
