"""The ctypes bindings of the CUDA sources, checked without a compiler:
every `extern "C"` entry point of csrc/*.cu has a declared signature in
ops/_native.py with the same number of parameters, each a pointer, an int
or a float as the C declaration says, and every source is built."""

import ctypes
import re

import pytest

from project3_cuda_path_tracer_tpu_torch.ops import _native

ENTRY = re.compile(r'extern "C" int (pt_\w+)\(([^)]*)\)', re.S)


def c_entry_points():
    found = {}
    for src in sorted(_native.CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            found[name] = [p.strip() for p in params.split(",")]
    return found


def test_every_source_is_built():
    assert sorted(_native.SOURCES) == sorted(_native.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", sorted(c_entry_points()))
def test_signature_matches_c_declaration(name):
    params = c_entry_points()[name]
    argtypes = _native.SIGNATURES[name]
    assert len(argtypes) == len(params), name
    for param, t in zip(params, argtypes):
        if "*" in param:
            want = ctypes.c_void_p
        elif param.startswith("float"):
            want = ctypes.c_float
        else:
            assert param.startswith("int"), param
            want = ctypes.c_int
        assert t is want, (name, param)
    assert set(_native.SIGNATURES) == set(c_entry_points())
