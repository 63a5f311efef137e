"""Each CUDA launcher's ctypes signature against its C prototype.

A ctypes declaration that disagrees with the ``extern "C"`` prototype in
``morefusion_tpu_torch/csrc/*.cu`` does not fail: it corrupts the
arguments on the card. Here every prototype is parsed from the sources and
held to the one :class:`_build.Kernel` handle in ``morefusion_tpu_torch/ops``
that declares it: the same number of parameters, of the same kinds in the
same order, and the same return type. Nothing is built or loaded.
"""

import ctypes
import importlib
import pkgutil
import re

import pytest

from morefusion_tpu_torch import ops
from morefusion_tpu_torch.ops import _build

# a C parameter's or return type's ctypes, the pointers apart
SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}
RETURNS = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}
PROTOTYPE = re.compile(r"^(int|const char\*)\s+(mfk_\w+)\(([^)]*)\)\s*\{",
                       re.MULTILINE)


def _extern_c(text):
    """The text of the ``extern "C" { ... }`` blocks of a source."""
    return "".join(re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text,
                              re.DOTALL))


def _param_type(param):
    """A C parameter's ctypes: ``c_void_p`` for any pointer."""
    param = " ".join(param.split())
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0].removeprefix("const ")
    return SCALARS[kind]


def prototypes():
    """``{name: (restype, [argtypes])}`` of every ``extern "C"`` function
    in the sources."""
    out = {}
    for src in _build.sources():
        for ret, name, params in PROTOTYPE.findall(
                _extern_c(src.read_text())):
            assert name not in out, f"{name} is defined twice"
            out[name] = (RETURNS[ret],
                         [_param_type(p) for p in params.split(",")])
    return out


def declarations():
    """``{name: [(module, Kernel), ...]}``: each distinct handle of the ops
    modules under its function's name."""
    seen, out = set(), {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for value in vars(module).values():
            if isinstance(value, _build.Kernel) and id(value) not in seen:
                seen.add(id(value))
                out.setdefault(value.name, []).append((info.name, value))
    return out


PROTOTYPES = prototypes()


def test_the_sources_hold_every_launcher():
    assert sorted(PROTOTYPES) == [
        "mfk_error_string", "mfk_instance_boxes", "mfk_knn", "mfk_min_dist",
        "mfk_min_dist_splits", "mfk_nms", "mfk_resize_backward",
        "mfk_resize_forward", "mfk_roi_align"]


@pytest.mark.parametrize("name", sorted(PROTOTYPES))
def test_one_declaration_matches_the_prototype(name):
    found = declarations().get(name, [])
    assert len(found) == 1, f"{name} declared by {[m for m, _ in found]}"
    module, kernel = found[0]
    restype, argtypes = PROTOTYPES[name]
    assert kernel.restype is restype, module
    assert list(kernel.argtypes) == argtypes, module


def test_every_declaration_has_a_prototype():
    assert set(declarations()) <= set(PROTOTYPES)


def test_launchers_end_with_device_and_stream():
    for name, (_, argtypes) in PROTOTYPES.items():
        if name not in ("mfk_error_string", "mfk_min_dist_splits"):
            assert argtypes[-2:] == [ctypes.c_int, ctypes.c_void_p], name
