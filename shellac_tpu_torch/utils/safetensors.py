"""safetensors files and HF checkpoint directories, without the
`safetensors` package (the port depends on no package but torch, numpy
and, for chat templates, jinja2).

A port-only module: the JAX package reads checkpoints through
`transformers`. The format is an 8-byte little-endian header length N,
N bytes of a JSON header ({name: {"dtype", "shape", "data_offsets":
[begin, end]}}, and an optional "__metadata__" of strings), then the raw
little-endian bytes of every tensor, with offsets counted from the end of
the header.

Reading maps each file (`mmap`) and hands out CPU tensors that view the
mapping, so a caller that moves a tensor to the card copies its bytes
once, from the page cache to the device. `CheckpointDir` opens what
`save_pretrained` writes: one `model.safetensors`, shards behind
`model.safetensors.index.json`, or `pytorch_model.bin` files (through
`torch.load(weights_only=True)`). `save_file` and `save_sharded` write
what `safetensors.torch.load_file` and `from_pretrained` read.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}

SAFE_INDEX = "model.safetensors.index.json"
SAFE_SINGLE = "model.safetensors"
BIN_INDEX = "pytorch_model.bin.index.json"
BIN_SINGLE = "pytorch_model.bin"
# The header may not exceed this (the reference implementation's limit).
_MAX_HEADER = 100 << 20


class SafetensorsFile:
    """One .safetensors file, mapped read-only (copy on write: nothing is
    ever written back). `tensor(name)` is a CPU tensor over the mapping."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes")
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size else None)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._entries = header
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise NotImplementedError(
                    f"{path}: tensor {name!r} has dtype {e['dtype']} "
                    f"(have {', '.join(DTYPES)})")
            b, end = e["data_offsets"]
            want = _numel(e["shape"]) * DTYPES[e["dtype"]].itemsize
            if end - b != want or self._start + end > size:
                raise ValueError(f"{path}: tensor {name!r} has "
                                 f"{end - b} bytes, wants {want}")

    def keys(self) -> List[str]:
        return list(self._entries)

    def tensor(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        b, end = e["data_offsets"]
        if end == b:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - b,
                               offset=self._start + b)
        return raw.view(dtype).reshape(shape)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` as one safetensors file (written to a temporary
    name, then renamed into place)."""
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("safetensors metadata maps str to str")
        header["__metadata__"] = dict(metadata)
    at = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"{name!r}: dtype {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(_tensor_bytes(t))
    os.replace(tmp, path)


def save_sharded(tensors: Dict[str, torch.Tensor], directory: str,
                 shards: int = 1) -> List[str]:
    """Write `tensors` into `directory` as `save_pretrained` does: one
    `model.safetensors`, or `shards` files of about equal bytes named
    model-0000i-of-0000n.safetensors with their index. Returns the
    files written."""
    os.makedirs(directory, exist_ok=True)
    meta = {"format": "pt"}
    if shards <= 1:
        save_file(tensors, os.path.join(directory, SAFE_SINGLE), meta)
        return [SAFE_SINGLE]
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups: List[Dict[str, torch.Tensor]] = [{} for _ in range(shards)]
    at = 0
    for name, t in tensors.items():
        groups[min(at * shards // max(total, 1), shards - 1)][name] = t
        at += t.numel() * t.element_size()
    names, weight_map = [], {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file(group, os.path.join(directory, fname), meta)
        names.append(fname)
        weight_map.update({k: fname for k in group})
    with open(os.path.join(directory, SAFE_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return names + [SAFE_INDEX]


class CheckpointDir(Mapping):
    """The state dict of an HF checkpoint directory, by name: each value
    is read when asked for (a CPU tensor over the file's mapping for
    safetensors)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._where: Dict[str, str] = {}
        self._files: Dict[str, SafetensorsFile] = {}
        self._bins: Dict[str, Dict[str, torch.Tensor]] = {}
        join = lambda n: os.path.join(directory, n)  # noqa: E731
        if os.path.exists(join(SAFE_INDEX)):
            self._index(join(SAFE_INDEX))
        elif os.path.exists(join(SAFE_SINGLE)):
            self._open(SAFE_SINGLE)
        elif os.path.exists(join(BIN_INDEX)):
            self._index(join(BIN_INDEX))
        elif os.path.exists(join(BIN_SINGLE)):
            self._open(BIN_SINGLE)
        else:
            raise FileNotFoundError(
                f"{directory}: no {SAFE_SINGLE}, {SAFE_INDEX}, {BIN_SINGLE} "
                f"or {BIN_INDEX}")

    def _index(self, path: str) -> None:
        with open(path) as f:
            weight_map = json.load(f)["weight_map"]
        for fname in sorted(set(weight_map.values())):
            self._open(fname)
        missing = [k for k in weight_map if k not in self._where]
        if missing:
            raise KeyError(f"{path} names tensors its shards lack: "
                           f"{missing[:4]}")

    def _open(self, fname: str) -> None:
        path = os.path.join(self.directory, fname)
        if fname.endswith(".safetensors"):
            f = self._files[fname] = SafetensorsFile(path)
            names = f.keys()
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            self._bins[fname] = sd
            names = list(sd)
        for k in names:
            self._where[k] = fname

    def __getitem__(self, name: str) -> torch.Tensor:
        fname = self._where[name]
        if fname in self._files:
            return self._files[fname].tensor(name)
        return self._bins[fname][name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)
