"""The ctypes bindings of the port's CUDA launchers against their C side.

`shellac_tpu_torch/ops/_build.py` declares each launcher's argument types
in `_SIGNATURES`; the launchers are the `extern "C" int shellac_*(...)`
functions of `shellac_tpu_torch/csrc/*.cu`. A pointer declared as an int
is cut to 32 bits without any error, and a missing or extra argument
shifts every one after it, so the two lists are held to each other here,
on the CPU, from the sources alone: the same names, the same number of
arguments, `c_void_p` exactly where the C side takes a pointer, `c_int`
for an int and `c_float` for a float.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import ctypes
import re

import pytest

from shellac_tpu_torch.ops import _build

_LAUNCHER = re.compile(r'extern\s+"C"\s+int\s+(shellac_\w+)\s*\(([^)]*)\)',
                       re.S)
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_launchers():
    """name -> list of C parameter declarations, from every .cu source."""
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for name, params in _LAUNCHER.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = [p.strip() for p in params.split(",")]
    return found


def _ctype(decl):
    """The ctypes type a C parameter declaration needs."""
    if "*" in decl:
        return ctypes.c_void_p
    base = decl.replace("const", "").split()[0]
    return _SCALARS[base]


def test_every_launcher_is_bound():
    assert sorted(_c_launchers()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_the_c_signature(name):
    params = _c_launchers()[name]
    bound = _build._SIGNATURES[name]
    assert len(bound) == len(params), (name, len(bound), len(params))
    for i, (decl, ct) in enumerate(zip(params, bound)):
        assert ct is _ctype(decl), (name, i, decl, ct)
