"""Host-side data pipeline.

Port of `shellac_tpu/training/data.py`: the token shard format
(`write_token_shard` :31, `read_token_shard` :39; the same bytes, so a
shard either package writes reads in the other), `token_batches` (:52),
`shard_batches` (:123) over the pure-Python reader, `pack_documents`
(:166), `batch_rows` (:216) and `device_prefetch` (:228). Batches are
dicts of numpy arrays {"inputs", "targets"} (and "segment_ids", "mask"
for packed rows), drawn by the same numpy generator calls as the
reference, so both packages see the same stream from the same seed.

Not ported: the native C++ shard loader (`shellac_tpu/runtime/`;
`shard_batches` reads shards in Python, as the reference does when the
library is not built) and multi-process batches (`distribute_batches`
with a mesh raises NotImplementedError).
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device

_MAGIC = b"STSH"  # shellac tpu shard
_HEADER = struct.Struct("<4sIQ")  # magic, version, num_tokens


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write int32 tokens as a binary shard (header + raw little-endian)."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, tokens.size))
        f.write(tokens.astype("<i4").tobytes())


def read_token_shard(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, version, n = _HEADER.unpack(f.read(_HEADER.size))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a token shard (bad magic {magic!r})")
        if version != 1:
            raise ValueError(f"{path}: unsupported shard version {version}")
        data = np.frombuffer(f.read(n * 4), dtype="<i4").astype(np.int32)
        if data.size != n:
            raise ValueError(f"{path}: truncated shard ({data.size} != {n})")
        return data


def token_batches(tokens: np.ndarray, *, batch_size: int, seq_len: int,
                  seed: int = 0, num_batches: Optional[int] = None,
                  skip: int = 0) -> Iterator[dict]:
    """Random contiguous windows: inputs = w[:-1], targets = w[1:].

    `skip` fast-forwards the sampler past that many batches without
    making them, so a resumed run (a checkpoint at step N, skip=N)
    continues the same stream instead of replaying it.
    """
    tokens = np.asarray(tokens, dtype=np.int32)
    if tokens.size < seq_len + 1:
        raise ValueError(f"corpus of {tokens.size} tokens < seq_len+1")
    rng = np.random.default_rng(seed)
    for _ in range(skip):
        rng.integers(0, tokens.size - seq_len, size=batch_size)
    produced = 0
    while num_batches is None or produced < num_batches:
        # Valid starts are [0, size - seq_len - 1]: a window takes
        # seq_len + 1 tokens; integers() has an exclusive high.
        starts = rng.integers(0, tokens.size - seq_len, size=batch_size)
        window = np.stack([tokens[s:s + seq_len + 1] for s in starts])
        yield {"inputs": window[:, :-1], "targets": window[:, 1:]}
        produced += 1


def distribute_batches(it: Iterator[dict], mesh=None) -> Iterator[dict]:
    """Per-process local batches into global ones on a multi-process
    mesh: one process passes its batches through; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "distribute_batches over a mesh is not ported: the port "
            "trains on one card")
    yield from it


def shard_batches(paths: Sequence[str], *, batch_size: int, seq_len: int,
                  seed: int = 0, num_batches: Optional[int] = None,
                  skip: int = 0, mesh=None) -> Iterator[dict]:
    """Batches drawn from the concatenation of token shards, by
    `token_batches` (the reference's pure-Python path; `skip` resumes the
    stream past batches already trained on)."""
    if mesh is not None:
        raise NotImplementedError(
            "shard_batches over a mesh is not ported: the port trains on "
            "one card")
    corpus = np.concatenate([read_token_shard(p) for p in paths])
    yield from token_batches(corpus, batch_size=batch_size, seq_len=seq_len,
                             seed=seed, num_batches=num_batches, skip=skip)


def pack_documents(docs, *, seq_len: int, pad_id: int = 0
                   ) -> Iterator[dict]:
    """Greedy packing of documents into fixed-length rows.

    Yields one row at a time: "inputs", "targets" (seq_len,),
    "segment_ids" (seq_len,) int32 (0 marks padding) and "mask"
    (seq_len,) fp32 (1 only where the target stays in the same
    document). With forward(segment_ids=...) each packed document trains
    as if it were alone in its row. Documents longer than seq_len + 1
    are truncated.
    """
    row_tok: list = []
    row_seg: list = []
    seg = 1

    def emit():
        t = np.full((seq_len + 1,), pad_id, np.int32)
        g = np.zeros((seq_len + 1,), np.int32)
        t[:len(row_tok)] = row_tok
        g[:len(row_seg)] = row_seg
        same = (g[1:] == g[:-1]) & (g[:-1] > 0)
        return {"inputs": t[:-1], "targets": t[1:], "segment_ids": g[:-1],
                "mask": same.astype(np.float32)}

    for doc in docs:
        d = np.asarray(doc, np.int32).reshape(-1)[:seq_len + 1]
        if d.size < 2:
            continue
        if row_tok and len(row_tok) + d.size > seq_len + 1:
            yield emit()
            row_tok, row_seg = [], []
        row_tok.extend(d.tolist())
        row_seg.extend([seg] * d.size)
        seg += 1
    if row_tok:
        yield emit()


def batch_rows(rows: Iterator[dict], batch_size: int) -> Iterator[dict]:
    """Group per-row dicts into stacked batches (drops a partial tail)."""
    buf: list = []
    for r in rows:
        buf.append(r)
        if len(buf) == batch_size:
            yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}
            buf = []


def device_prefetch(it: Iterator[dict], *, device: DeviceLike = None,
                    depth: int = 2) -> Iterator[dict]:
    """Batches as tensors on `device` (the card by default), staged one
    step ahead through pinned host memory.

    On the card, a worker thread draws the next numpy batches and copies
    them into pinned buffers (host memory copies only); the calling
    thread, which alone issues work on the card, copies each buffer to
    the device without blocking and hands the buffer back once its copy
    has completed. `depth` buffers are filled ahead. A batch whose shapes
    differ from the first one's is copied from pageable memory. On the
    CPU the batches are converted in the calling thread.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in it:
            yield {k: torch.as_tensor(np.asarray(v), device=dev)
                   for k, v in batch.items()}
        return
    it = iter(it)
    try:
        first = {k: np.ascontiguousarray(v) for k, v in next(it).items()}
    except StopIteration:
        return
    slots = [{k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                             pin_memory=True) for k, v in first.items()}
             for _ in range(depth + 1)]
    views = [{k: t.numpy() for k, t in s.items()} for s in slots]
    free: queue.Queue = queue.Queue()
    ready: queue.Queue = queue.Queue(maxsize=depth + 1)
    closed = threading.Event()
    stop = object()

    def fill(i, batch):
        for k, v in batch.items():
            np.copyto(views[i][k], v)

    def take_free():
        while not closed.is_set():
            try:
                return free.get(timeout=0.5)
            except queue.Empty:
                continue
        return None

    def send(item) -> bool:
        """Queue an item unless the consumer has gone (a worker parked in
        put() would outlive the run)."""
        while not closed.is_set():
            try:
                ready.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in it:
                batch = {k: np.ascontiguousarray(v) for k, v in batch.items()}
                if set(batch) != set(first) or any(
                        batch[k].shape != first[k].shape
                        or batch[k].dtype != first[k].dtype for k in batch):
                    if not send(("raw", batch)):
                        return
                    continue
                i = take_free()
                if i is None:
                    return
                fill(i, batch)
                if not send(("slot", i)):
                    return
        except BaseException as e:  # re-raised in the consumer
            send(("error", e))
        else:
            send(("stop", stop))

    fill(0, first)
    for i in range(1, depth + 1):
        free.put(i)
    inflight = []  # (slot, event) whose device copies may be running
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    item = ("slot", 0)
    try:
        while True:
            kind, val = item
            if kind == "stop":
                return
            if kind == "error":
                raise val
            if kind == "raw":
                out = {k: torch.from_numpy(v).to(dev)
                       for k, v in val.items()}
            else:
                out = {k: s.to(dev, non_blocking=True)
                       for k, s in slots[val].items()}
                ev = torch.cuda.Event()
                ev.record()
                inflight.append((val, ev))
            yield out
            # Hand back the buffers whose copies are done; the oldest
            # waits for its copy when the worker would otherwise starve.
            while inflight and (inflight[0][1].query()
                                or (free.empty() and ready.empty())):
                slot, ev = inflight.pop(0)
                ev.synchronize()
                free.put(slot)
            item = ready.get()
    finally:
        closed.set()
