"""Checkpoint and resume of a TrainState, with integrity tracking.

The port of `shellac_tpu/training/checkpoint.py` (`latest_step_on_disk`
:90, `Checkpointer` :104) over `torch.save` and
`torch.load(weights_only=True)` instead of orbax. A step is one
directory, `<root>/<step>/state.pt`, holding the state as nested
dictionaries and lists of CPU tensors and ints (the port's TrainState:
params, the optimizer's count and moments, step, the EMA). The reference's
integrity contract holds:

  - every `save` writes a per-step manifest (leaf count, digest of the
    sorted (path, shape, dtype) rows, the rows) under `manifests/`;
  - `verify(step)` checks a step against its manifest from the file's
    tensor headers (a memory-mapped load reads no array data);
  - `restore(..., fallback=True)` walks steps newest to oldest past
    corrupt or partial ones, quarantining each (renamed
    `<step>.corrupt`, never selected again);
  - a save is written to `<step>.checkpoint-tmp-<ns>` and committed by an
    atomic rename; construction sweeps abandoned tmp directories and
    orphan manifests older than DEBRIS_TTL_S.

`save` is asynchronous by default: the state is copied to host memory
before it returns, and a thread writes and commits it; `wait`, `close`
and the next `save` wait for it (and raise what it raised). Restores land
on the device the caller names. Sharded restores (`mesh=`) are not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

from shellac_tpu_torch.config import ModelConfig, TrainConfig
from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device
from shellac_tpu_torch.training.optimizer import (
    FactoredState,
    LionState,
    init_opt_state,
)
from shellac_tpu_torch.training.train_state import AdamWState, TrainState

# A save is written under `<step><marker><ns>` and renamed to `<step>`
# when complete; anything still carrying the marker is an interrupted
# save.
TMP_DIR_MARKER = ".checkpoint-tmp-"
# Debris younger than this may be ANOTHER process's live async save: it
# is left alone (it is never selectable as a step either way).
DEBRIS_TTL_S = 3600.0
CORRUPT_SUFFIX = ".corrupt"
ITEM = "state.pt"
_MANIFEST_DIRNAME = "manifests"
_MANIFEST_VERSION = 1
_CORRUPT_MANIFEST = object()

Row = Tuple[str, Tuple[int, ...], str]


def _metrics():
    from shellac_tpu_torch.training.resilience import ResilienceMetrics

    return ResilienceMetrics()


# The optimizer states by their saved keys (adamw and muon share one).
_OPT_STATES = {("mu", "nu"): AdamWState, ("mu",): LionState,
               ("v", "v_col", "v_row"): FactoredState}


def _as_tree(state: TrainState) -> dict:
    """The saved form of a TrainState: dicts, lists, tensors and ints."""
    opt = state.opt_state
    return {
        "step": int(state.step),
        "params": state.params,
        "opt_state": {"count": int(opt.count),
                      **{k: v for k, v in vars(opt).items()
                         if k != "count"}},
        "ema_params": state.ema_params,
    }


def _from_tree(tree: dict) -> TrainState:
    opt = dict(tree["opt_state"])
    count = int(opt.pop("count"))
    cls = _OPT_STATES[tuple(sorted(opt))]
    return TrainState(step=int(tree["step"]), params=tree["params"],
                      opt_state=cls(count=count, **opt),
                      ema_params=tree.get("ema_params"))


def _flatten(tree, prefix: str = ""):
    """(path, leaf) over dicts and lists; None subtrees hold no leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _map(fn, tree, prefix: str = ""):
    """A tree of the same structure, fn(path, leaf) at every leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def _leaf_rows(tree) -> List[Row]:
    """Sorted (path, shape, dtype) rows of every leaf (ints as 0-d int64)."""
    rows = []
    for path, x in _flatten(tree):
        if isinstance(x, torch.Tensor):
            rows.append((path, tuple(int(s) for s in x.shape),
                         str(x.dtype).replace("torch.", "")))
        else:
            rows.append((path, (), "int64"))
    return sorted(rows)


def _rows_digest(rows: List[Row]) -> str:
    canonical = json.dumps(
        [[p, list(s), d] for p, s, d in rows], separators=(",", ":")
    )
    return hashlib.sha256(canonical.encode()).hexdigest()


def latest_step_on_disk(directory: str) -> Optional[int]:
    """Newest committed step in a checkpoint directory, by directory scan
    alone (no Checkpointer, no sweep); quarantined and uncommitted tmp
    directories never count."""
    root = os.path.abspath(directory)
    if not os.path.isdir(root):
        return None
    steps = [int(name) for name in os.listdir(root)
             if name.isdigit() and os.path.isdir(os.path.join(root, name))]
    return max(steps) if steps else None


def abstract_train_state(model_cfg: ModelConfig,
                         train_cfg: TrainConfig) -> TrainState:
    """The structure `init_train_state` gives, as `meta` tensors (shapes
    and dtypes, no storage): the `abstract_state` of a restore."""
    from shellac_tpu_torch.models.transformer import (
        layer_shapes,
        moe_layers,
        stack_prefixes,
    )

    pdt = model_cfg.params_dtype

    def tree(dtype):
        def leaf(shape):
            return torch.empty(shape, dtype=dtype, device="meta")

        t = {"embed": leaf((model_cfg.vocab_size, model_cfg.d_model)),
             "layers": [{n: leaf(shp) for n, (shp, _) in
                         layer_shapes(model_cfg, flag).items()}
                        for flag in moe_layers(model_cfg)],
             "final_norm": leaf((model_cfg.d_model,))}
        if not model_cfg.tie_embeddings:
            t["lm_head"] = leaf((model_cfg.d_model, model_cfg.vocab_size))
        return t

    return TrainState(
        step=0, params=tree(pdt),
        opt_state=init_opt_state(train_cfg, tree(pdt),
                                 stack_prefixes(model_cfg)),
        ema_params=tree(pdt) if train_cfg.ema_decay is not None else None)


class Checkpointer:
    """Saves and restores TrainStates under one directory."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self._root = os.path.abspath(directory)
        self._manifest_dir = os.path.join(self._root, _MANIFEST_DIRNAME)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        # Steps this process has seen fail verification or restore.
        self._quarantined: set = set()
        # Newest async-saved step not yet known committed (the gauge
        # moves at the next wait/save/close: a commit barrier).
        self._pending_last_good: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._sweep_interrupted_saves()
        os.makedirs(self._root, exist_ok=True)
        self._sweep_orphan_manifests()

    @property
    def directory(self) -> str:
        return self._root

    # ---- integrity: sweep / manifest / verify / quarantine -----------

    def _sweep_interrupted_saves(self) -> List[str]:
        """Remove uncommitted tmp directories older than DEBRIS_TTL_S: a
        kill mid-save leaves exactly this debris, and a young one may be
        a concurrent process's live save."""
        removed: List[str] = []
        if not os.path.isdir(self._root):
            return removed
        now = time.time()
        for name in sorted(os.listdir(self._root)):
            if TMP_DIR_MARKER not in name:
                continue
            path = os.path.join(self._root, name)
            try:
                if now - os.path.getmtime(path) < DEBRIS_TTL_S:
                    continue
            except OSError:
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        return removed

    def _sweep_orphan_manifests(self) -> None:
        """Drop manifests whose step no longer exists, with the same
        freshness guard (a manifest is written before its async save
        commits)."""
        if not os.path.isdir(self._manifest_dir):
            return
        now = time.time()
        for name in sorted(os.listdir(self._manifest_dir)):
            step = name[:-5] if name.endswith(".json") else None
            if step is None or not step.isdigit():
                continue
            path = os.path.join(self._manifest_dir, name)
            try:
                if now - os.path.getmtime(path) < DEBRIS_TTL_S:
                    continue
            except OSError:
                continue
            if not os.path.isdir(os.path.join(self._root, step)):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{int(step)}.json")

    def _write_manifest(self, step: int, tree: dict) -> None:
        rows = _leaf_rows(tree)
        manifest = {
            "format": _MANIFEST_VERSION,
            "step": int(step),
            "leaf_count": len(rows),
            "tree_digest": _rows_digest(rows),
            "leaves": [[p, list(s), d] for p, s, d in rows],
        }
        os.makedirs(self._manifest_dir, exist_ok=True)
        tmp = self._manifest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path(step))

    def _read_manifest(self, step: int):
        """The step's manifest, None when absent, or `_CORRUPT_MANIFEST`
        when present but unreadable (writes are atomic: that is rot)."""
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError):
            return _CORRUPT_MANIFEST

    def _item(self, step: int) -> str:
        return os.path.join(self._root, str(int(step)), ITEM)

    def _load(self, step: int) -> dict:
        """The step's saved tree, memory-mapped (no array data read)."""
        return torch.load(self._item(step), map_location="cpu",
                          weights_only=True, mmap=True)

    def item_metadata(self, step: int) -> List[Row]:
        return _leaf_rows(self._load(step))

    def verify(self, step: int) -> Optional[str]:
        """None if a saved step passes, else the reason: it must be
        committed, its file's headers readable, and (when it has a
        manifest) its leaf count, digest and every leaf's shape and dtype
        must match. Array data is not re-read: rot that survives these
        surfaces as a restore error, which the fallback walk treats the
        same way."""
        if step in self._quarantined:
            return "step is quarantined"
        if step not in self._committed_steps():
            return f"step {step} is not a finalized checkpoint"
        try:
            rows = self.item_metadata(step)
        except Exception as e:  # truncated or scrambled file
            return f"unreadable checkpoint metadata ({type(e).__name__}: {e})"
        manifest = self._read_manifest(step)
        if manifest is None:
            return None
        if manifest is _CORRUPT_MANIFEST:
            return "unreadable integrity manifest"
        if len(rows) != manifest["leaf_count"]:
            return (f"leaf count {len(rows)} != manifest "
                    f"{manifest['leaf_count']}")
        if _rows_digest(rows) != manifest["tree_digest"]:
            want = {p: (tuple(s), d) for p, s, d in manifest["leaves"]}
            for p, s, d in rows:
                if p not in want:
                    return f"unexpected leaf {p!r}"
                if want[p] != (s, d):
                    return (f"leaf {p!r} is {s}/{d}, manifest says "
                            f"{want[p][0]}/{want[p][1]}")
            return "tree structure digest mismatch"
        return None

    def quarantine(self, step: int, reason: str = "") -> None:
        """Take a bad step out of circulation: renamed `<step>.corrupt`
        (or `.corrupt.<n>` when that exists), its manifest dropped."""
        self._quarantined.add(step)
        src = os.path.join(self._root, str(step))
        dst = src + CORRUPT_SUFFIX
        n = 1
        while os.path.exists(dst):
            n += 1
            dst = f"{src}{CORRUPT_SUFFIX}.{n}"
        try:
            if os.path.isdir(src):
                os.rename(src, dst)
                with open(os.path.join(dst, "QUARANTINE.json"), "w") as f:
                    json.dump({"step": int(step), "reason": reason,
                               "time": time.time()}, f)
        except OSError:
            pass  # the local exclusion above still holds
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass
        _metrics().quarantined.inc()

    # ---- save / restore ----------------------------------------------

    def _committed_steps(self) -> List[int]:
        if not os.path.isdir(self._root):
            return []
        return sorted(int(n) for n in os.listdir(self._root)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._root, n)))

    def all_steps(self) -> List[int]:
        return [s for s in self._committed_steps()
                if s not in self._quarantined]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def save(self, step: int, state: TrainState, *, force: bool = False,
             wait: bool = False) -> bool:
        """Save (async by default). Returns True if a save was started:
        not for a step already saved, nor (unless `force`) for one at or
        below the latest step or off the save interval."""
        self._join()
        self._flush_last_good()
        steps = self.all_steps()
        latest = max(steps) if steps else None
        if step in steps or (not force and (
                (latest is not None and step <= latest)
                or (latest is not None
                    and step % self.save_interval_steps != 0))):
            return False
        tree = _map(lambda _, x: (x.detach().to("cpu", copy=True)
                                  if isinstance(x, torch.Tensor) else x),
                    _as_tree(state))
        # A re-save of a once-quarantined step number is a fresh, healthy
        # checkpoint.
        self._quarantined.discard(step)
        self._write_manifest(step, tree)
        self._writer = threading.Thread(
            target=self._write, args=(int(step), tree),
            name=f"checkpoint-save-{step}", daemon=True)
        self._writer.start()
        # The gauge moves only once the save commits.
        self._pending_last_good = int(step)
        if wait:
            self.wait()
        return True

    def _write(self, step: int, tree: dict) -> None:
        try:
            tmp = os.path.join(self._root,
                               f"{step}{TMP_DIR_MARKER}{time.time_ns()}")
            os.makedirs(tmp)
            with open(os.path.join(tmp, ITEM), "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(self._root, str(step)))
            self._keep_newest()
        except BaseException as e:
            self._write_error = e

    def _keep_newest(self) -> None:
        """Delete the steps past max_to_keep. Their manifests stay, as the
        reference's do, until a later construction's orphan sweep."""
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self._root, str(old)),
                          ignore_errors=True)

    def _join(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            self._pending_last_good = None
            raise RuntimeError("checkpoint save failed") from err

    def _flush_last_good(self) -> None:
        if self._pending_last_good is not None:
            _metrics().last_good_step.set(self._pending_last_good)
            self._pending_last_good = None

    def restore(self, step: Optional[int] = None, *,
                abstract_state: Optional[TrainState] = None,
                device: DeviceLike = None, mesh=None, model_cfg=None,
                fallback: bool = False) -> TrainState:
        """Restore a TrainState onto `device` (the card unless told
        otherwise). With `abstract_state` (e.g. `abstract_train_state`)
        the saved leaves must have its paths and shapes, and each lands
        in its dtype (saved-vs-requested dtype drift is cast). Params
        come back requiring grad, as `train_state_from_params` leaves
        them. With `fallback=True`, a step that fails verification or
        restore is quarantined and the walk goes on to the next newest.
        """
        if mesh is not None:
            raise NotImplementedError(
                "sharded restores (mesh=) are not ported yet")
        dev = resolve_device(device)
        self._join()
        self._flush_last_good()
        if fallback:
            return self._restore_fallback(step, abstract_state, dev)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return self._restore_step(step, abstract_state, dev)

    def _restore_fallback(self, step, abstract_state, dev) -> TrainState:
        newest = True
        last_err: Optional[Exception] = None
        while True:
            steps = [s for s in self.all_steps()
                     if step is None or s <= step]
            if not steps:
                at = f" at or below step {step}" if step is not None else ""
                raise FileNotFoundError(
                    f"no intact checkpoints in {self.directory}{at}"
                ) from last_err
            s = max(steps)
            reason = self.verify(s)
            if reason is None:
                if self._request_mismatch(s, abstract_state):
                    # The caller asked for another structure (wrong
                    # preset, config or EMA flag): the step is healthy,
                    # and so would every older one be.
                    raise ValueError(
                        f"requested state structure does not match "
                        f"checkpoint step {s} in {self.directory} "
                        "(wrong preset/config/optimizer/EMA flags?); "
                        "refusing to restore"
                    )
                try:
                    out = self._restore_step(s, abstract_state, dev)
                    if not newest:
                        _metrics().fallback_restores.inc()
                    _metrics().last_good_step.set(int(s))
                    return out
                except Exception as e:
                    last_err = e
                    reason = f"restore failed ({type(e).__name__}: {e})"
            self.quarantine(s, reason)
            newest = False

    def _request_mismatch(self, step: int, abstract_state) -> bool:
        """True when the requested structure (paths and shapes; dtypes may
        drift) differs from what the step verifiably holds. Unreadable
        saved-side records mean damage, never a request mismatch."""
        if abstract_state is None:
            return False
        manifest = self._read_manifest(step)
        if isinstance(manifest, dict):
            saved = [(p, tuple(sh)) for p, sh, _ in manifest["leaves"]]
        else:
            try:
                saved = [(p, sh) for p, sh, _ in self.item_metadata(step)]
            except Exception:
                return False
        want = [(p, sh) for p, sh, _ in _leaf_rows(_as_tree(abstract_state))]
        return sorted(saved) != sorted(want)

    def _restore_step(self, step: int, abstract_state,
                      dev: torch.device) -> TrainState:
        tree = self._load(step)
        if abstract_state is not None:
            if self._request_mismatch(step, abstract_state):
                raise ValueError(
                    f"requested state structure does not match checkpoint "
                    f"step {step} in {self.directory}")
            tree = self._restore_saved_dtypes(tree, _as_tree(abstract_state))
        state = _from_tree(_map(
            lambda _, x: (x.to(dev, copy=True) if isinstance(x, torch.Tensor)
                          else x), tree))
        for _, p in _flatten(state.params):
            p.requires_grad_(True)
        return state

    @staticmethod
    def _restore_saved_dtypes(tree: dict, want: dict) -> dict:
        """The saved tree in the requested structure, each leaf cast from
        its saved dtype to the requested one where the two differ."""
        saved = dict(_flatten(tree))

        def take(path, like):
            x = saved[path]
            if isinstance(like, torch.Tensor) and isinstance(x, torch.Tensor):
                return x.to(like.dtype) if x.dtype != like.dtype else x
            return x

        return _map(take, want)

    def wait(self) -> None:
        self._join()
        self._flush_last_good()

    def close(self) -> None:
        """Wait for any save in flight (closing mid-write would leave the
        newest step uncommitted), then release nothing else: the
        Checkpointer holds no open files."""
        self.wait()
