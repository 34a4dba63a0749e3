"""Checkpointing with atomic commits, async save and retention.

Layout (one directory per step), the same as the reference package's, so
either package reads the other's checkpoints:

    <dir>/step_000000420/
        meta.json            # leaf keys, shapes, dtypes, step, extras
        h0_l0000.npy ...     # one .npy per leaf, in key order
        COMMIT               # written LAST; a step without COMMIT is garbage

A tree is a dict of arrays, nested dicts, lists or tuples. Leaves are
numpy arrays, scalars or torch tensors (a tensor on the card is brought to
the host before the write); ``None`` holds no leaf. Leaves are visited in
the order the reference's ``jax.tree_util`` walk visits them — dict keys
sorted, sequences by index — and keyed as its ``keystr`` writes them
(``"['ptr']"`` for a flat dict, ``"['a'][0]"`` nested).

Properties:
  * **atomic**: the COMMIT marker is written after every array lands, and
    only ``os.replace`` of the staging dir commits — a killed save can never
    be mistaken for a valid checkpoint;
  * **async**: ``save_checkpoint(..., blocking=False)`` captures the arrays
    on the host and writes on a worker thread;
  * **retention**: ``keep_last`` prunes old steps, never the newest commit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "load_checkpoint_arrays",
    "latest_step",
    "CheckpointManager",
]

# Test seam for the fault-injection harness (repro_torch.ft.faults): when
# set, it is invoked at every named stage of the save path and may raise to
# simulate a process killed at exactly that point. Production never sets it.
_CRASH_HOOK = None


def _crash_point(stage: str, detail: int = 0) -> None:
    if _CRASH_HOOK is not None:
        _CRASH_HOOK(stage, detail)


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(skeleton, leaves):
    """Rebuild ``skeleton``'s structure from an iterator of new leaves."""
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        return {k: _unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _is_step_dir(name: str) -> bool:
    # a ".tmp" staging dir is never a step, even once its COMMIT marker has
    # been written — only the atomic os.replace into the final name commits
    return name.startswith("step_") and not name.endswith(".tmp")


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    best = None
    for name in os.listdir(base):
        if _is_step_dir(name) and os.path.exists(os.path.join(base, name, "COMMIT")):
            s = int(name.split("_")[1])
            best = s if best is None or s > best else best
    return best


def _gc_uncommitted(base: str) -> int:
    """Remove the debris a killed save leaves behind: ``.tmp`` staging dirs
    and step dirs without a COMMIT marker. Called at the start of every
    save, so one crash never accumulates garbage across restarts."""
    removed = 0
    if not os.path.isdir(base):
        return removed
    for name in os.listdir(base):
        full = os.path.join(base, name)
        stale_tmp = name.startswith("step_") and name.endswith(".tmp")
        uncommitted = _is_step_dir(name) and not os.path.exists(
            os.path.join(full, "COMMIT")
        )
        if stale_tmp or uncommitted:
            shutil.rmtree(full, ignore_errors=True)
            removed += 1
    return removed


def save_checkpoint(
    base: str,
    step: int,
    tree: Any,
    *,
    extras: Optional[dict] = None,
    blocking: bool = True,
    keep_last: int = 3,
) -> threading.Thread | None:
    """Capture ``tree`` on the host and persist it for ``step``."""
    flat = [(key, _to_host(v)) for key, v in _flatten(tree)]
    meta = {
        "step": step,
        "extras": extras or {},
        "leaves": [
            {
                "key": key,
                "file": f"h0_l{idx:04d}.npy",
                "shape": list(v.shape),
                "dtype": str(v.dtype),
            }
            for idx, (key, v) in enumerate(flat)
        ],
        "treedef": None,  # structure is re-derived from the restore skeleton
        "time": time.time(),
    }

    def write():
        d = _step_dir(base, step)
        tmp = d + ".tmp"
        _gc_uncommitted(base)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        for idx, (_, v) in enumerate(flat):
            _crash_point("array", idx)
            np.save(os.path.join(tmp, f"h0_l{idx:04d}.npy"), v)
        _crash_point("meta")
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        _crash_point("commit")
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        _crash_point("replace")
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        _prune(base, keep_last)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _prune(base: str, keep_last: int):
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(base)
        if _is_step_dir(n) and os.path.exists(os.path.join(base, n, "COMMIT"))
    )
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def _read_meta(base: str, step: Optional[int]) -> Tuple[str, int, dict]:
    step = latest_step(base) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "meta.json")) as f:
        return d, step, json.load(f)


def restore_checkpoint(
    base: str, skeleton: Any, *, step: Optional[int] = None
) -> tuple[Any, int, dict]:
    """Restore into the structure of ``skeleton`` (a tree whose leaves have
    ``shape`` and ``dtype``: numpy arrays or torch tensors). Each leaf's
    shape is checked; it comes back in the skeleton leaf's dtype — a torch
    tensor on the skeleton leaf's device, else a numpy array. Returns
    ``(tree, step, extras)``."""
    d, step, meta = _read_meta(base, step)
    by_key = {leaf["key"]: leaf for leaf in meta["leaves"]}
    out = []
    for key, leaf in _flatten(skeleton):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(d, by_key[key]["file"]))
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(arr.astype(leaf.dtype, copy=False))
    return _unflatten(skeleton, iter(out)), step, meta["extras"]


def load_checkpoint_arrays(
    base: str, *, step: Optional[int] = None
) -> tuple[Dict[str, np.ndarray], int, dict]:
    """Load a committed step as a flat ``{key: ndarray}`` map, no skeleton.

    :func:`restore_checkpoint` validates shapes against a caller-provided
    skeleton — impossible for state whose shapes are data-dependent (the
    DRFS index checkpoints: array lengths follow the streamed event count).
    This reads the same atomic-COMMIT layout and returns whatever shapes the
    checkpoint holds, keyed as written (a flat dict saved as ``{"x": ...}``
    comes back under ``"['x']"``). Returns ``(arrays, step, extras)``.
    """
    d, step, meta = _read_meta(base, step)
    arrays = {
        leaf["key"]: np.load(os.path.join(d, leaf["file"]))
        for leaf in meta["leaves"]
    }
    return arrays, step, meta["extras"]


class CheckpointManager:
    """Step-cadenced async checkpointing with a single in-flight writer."""

    def __init__(self, base: str, every: int = 100, keep_last: int = 3):
        self.base = base
        self.every = every
        self.keep_last = keep_last
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(base, exist_ok=True)

    def maybe_save(self, step: int, tree, extras=None, force=False):
        if not force and (step % self.every != 0):
            return False
        self.wait()
        self._inflight = save_checkpoint(
            self.base, step, tree, extras=extras, blocking=False, keep_last=self.keep_last
        )
        return True

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
