"""Build and load the port's CUDA kernels.

Every `*.cu` under `shellac_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface,
which is loaded with `ctypes`. The sources are compiled in parallel (one
`nvcc` process each, all started together) and linked once. The build
lands in `build/shellac_tpu_torch/<hash of sources and flags>/` at the
root of the checkout, at first use; nothing is fetched and nothing is
prebuilt. A card without `nvcc`, or a failing compile, raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "shellac_tpu_torch"
LIB_NAME = "libshellac_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes shared with csrc/common.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signature of every exported launcher: (name, argtypes).
_SIGNATURES = {
    # x, scale, out, rows, d, eps, dtype, stream
    "shellac_rms_norm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, sinks, seg, out, lse, B, S, H, Hkv, D, scale, causal,
    # window, softcap, dtype, stream
    "shellac_flash_attention": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I,
        _P,
    ),
    # q, k, v, dout, lse, delta, seg, dk, dv, B, S, H, Hkv, D, scale,
    # causal, window, softcap, dtype, stream
    "shellac_flash_attention_bwd_dkdv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
        _F, _I, _P,
    ),
    # q, k, v, dout, lse, delta, seg, dq, B, S, H, Hkv, D, scale, causal,
    # window, softcap, dtype, stream
    "shellac_flash_attention_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F,
        _I, _P,
    ),
    # q, k, v, index, sinks, out, B, s, H, Hkv, L, D, scale, window,
    # softcap, dtype, stream
    "shellac_decode_attention": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I, _P,
    ),
    # q, k, v, tables, index, sinks, out, B, s, H, Hkv, bs, max_blocks,
    # D, scale, window, softcap, dtype, stream
    "shellac_paged_decode_attention": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F,
        _I, _P,
    ),
    # q, k, v, ks, vs, index, sinks, out, B, s, H, Hkv, L, D, scale,
    # window, softcap, dtype (q's), stream
    "shellac_decode_attention_int8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F,
        _I, _P,
    ),
    # q, k, v, ks, vs, tables, index, sinks, out, B, s, H, Hkv, bs,
    # max_blocks, D, scale, window, softcap, dtype (q's), stream
    "shellac_paged_decode_attention_int8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
        _I, _F, _I, _P,
    ),
}


def _sources():
    return sorted(
        p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")
    )


def _build_key() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are compiled from source at first use"
    )


def _compile(out_dir: Path) -> dict:
    """Compile every .cu in parallel, link one .so; returns build info."""
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, objs, failed = {}, [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs[src.name] = out
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp / LIB_NAME), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    seconds = time.perf_counter() - t0
    (tmp / "ptxas.log").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in logs.items())
    )
    (tmp / "build_seconds").write_text(f"{seconds!r}\n")
    try:
        os.replace(tmp, out_dir)
    except OSError:
        # Another process finished the same build first; keep theirs.
        shutil.rmtree(tmp, ignore_errors=True)
    return {"built": True, "seconds": seconds}


@functools.cache
def _load():
    out_dir = BUILD_ROOT / _build_key()
    if (out_dir / LIB_NAME).exists():
        info = {"built": False, "seconds": 0.0}
    else:
        info = _compile(out_dir)
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    info["dir"] = str(out_dir)
    return lib, info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return _load()[0]


def build_info() -> dict:
    """How the library was obtained: build seconds, directory, and the
    `ptxas -v` lines (registers, shared memory, spills) per kernel."""
    lib, info = _load()
    log = Path(info["dir"]) / "ptxas.log"
    lines = log.read_text().splitlines() if log.exists() else []
    return {**info, "ptxas": [ln for ln in lines if ln.strip()]}


def launch(name: str, *args) -> None:
    """Call launcher `name` on the current stream; raise on a CUDA error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
