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


# `ptxas -v` lines of instances of the Hopper redesigns, as nvcc prints
# them, and the names the profiler gives their launches.
_PTXAS = """\
ptxas info    : Compiling entry function '_ZN7shellac4wide15decode_wide_mmaI13__nv_bfloat16NS_12_GLOBAL__N_110DenseTilesEEEvPKS2_PKT_PKfPKiPS2_iiiifT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN7shellac4wide15decode_wide_mmaI13__nv_bfloat16NS_12_GLOBAL__N_110DenseTilesEEEvPKS2_PKT_PKfPKiPS2_iiiifT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Function properties for _ZN7shellac4wide15decode_wide_mmaIaNS_12_GLOBAL__N_110PagedTilesEEEvPK13__nv_bfloat16PKT_PKfPKiPS3_iiiifT0_
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Function properties for _ZN7shellac4wide18decode_wide_kernelIfaLi576ENS_12_GLOBAL__N_110PagedTilesEEEvPKT_PKT0_PKfPKiPS4_iiiifT2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 472 bytes cmem[0]
ptxas info    : Function properties for _ZN7shellac12_GLOBAL__N_113rms_norm_rowsI13__nv_bfloat16Li64ELi8EEEvPKT_PKfPS3_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 150 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Function properties for _ZN7shellac12_GLOBAL__N_115rms_norm_kernelI13__nv_bfloat16Lb1EEEvPKT_PKfPS3_iif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 392 bytes cmem[0]
""".splitlines()


def test_spill_report_classifies_the_wide_and_rms_instances():
    import chip_smoke

    report = chip_smoke.spill_report(_PTXAS)
    got = {i["kernel"]: (i["spill_stores"], i["registers"])
           for i in report["instances"]}
    # The generic two-pass RMSNorm body is not a redesigned instance.
    assert got == {"decode_wide_mma": (0, 168), "paged_wide_mma": (12, 255),
                   "paged_wide": (0, 120), "rms_norm_rows": (0, 150)}
    assert report["counts"]["decode_wide_mma"] == 1
    assert report["counts"]["decode_wide"] == 0
    assert not report["c7520"]
    assert chip_smoke.spill_report(
        _PTXAS + ["ptxas warning : (C7520) wgmma serialized"])["c7520"]


@pytest.mark.parametrize("name,kind", [
    ("void shellac::wide::decode_wide_mma<__nv_bfloat16, shellac::(anonymous "
     "namespace)::DenseTiles>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, int const*, __nv_bfloat16*, int, int, int, int, float, "
     "shellac::(anonymous namespace)::DenseTiles)", "decode_attention_dense"),
    ("void shellac::wide::decode_wide_mma<signed char, shellac::(anonymous "
     "namespace)::PagedTiles>(__nv_bfloat16 const*, signed char const*, "
     "float const*, int const*, __nv_bfloat16*, int, int, int, int, float, "
     "shellac::(anonymous namespace)::PagedTiles)",
     "paged_decode_attention_int8"),
    ("void shellac::wide::decode_wide_kernel<float, signed char, 576, "
     "shellac::(anonymous namespace)::DenseTiles>(float const*, signed char "
     "const*, float const*, int const*, float*, int, int, int, int, float, "
     "shellac::(anonymous namespace)::DenseTiles)",
     "decode_attention_dense_int8"),
    ("void shellac::(anonymous namespace)::rms_norm_rows<__nv_bfloat16, 64, "
     "8>(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, "
     "float)", "rms_norm"),
])
def test_kernel_kind_of_the_wide_and_rms_instances(name, kind):
    import chip_smoke

    assert chip_smoke.kernel_kind(name) == kind
