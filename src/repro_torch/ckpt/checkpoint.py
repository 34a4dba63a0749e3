"""Checkpointing with atomic commits, async save and retention.

Layout (one directory per step), the same as the reference package's, so
either package reads the other's checkpoints:

    <dir>/step_000000420/
        meta.json            # leaf keys, shapes, dtypes, step, extras
        h0_l0000.npy ...     # one .npy per leaf, in key order
        COMMIT               # written LAST; a step without COMMIT is garbage

A tree is a dict of arrays, nested dicts, lists or tuples. Leaves are
numpy arrays, scalars or torch tensors (a tensor on the card is brought to
the host before the write; bfloat16 stored as the reference stores it);
``None`` holds no leaf. Leaves are visited in the order the reference's
``jax.tree_util`` walk visits them — dict keys sorted, sequences by index,
a NamedTuple's fields in order — and keyed as its ``keystr`` writes them
(``"['ptr']"`` for a flat dict, ``"['a'][0]"`` nested, ``"['opt'].mu['a']"``
for a field of a NamedTuple such as the optimizer's ``AdamWState``).

A tree held in blocks over several processes (``shardings=``: a tree of
``sharding.process.Blocks`` shaped like the tree) is saved in the same
layout, each leaf whole: gathered leaf by leaf to rank 0, which writes it
and drops it (the host never holds the whole state), then commits after a
barrier. ``restore_checkpoint(..., shardings=)`` reads only this rank's
block of each leaf (``np.load(mmap_mode='r')``), so a checkpoint taken on
one mesh restores onto another, or whole in one process: the reference's
reshard-on-restore.

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


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):  # fields by name, as keystr writes a GetAttrKey
        out = []
        for name, v in zip(tree._fields, tree):
            out += _flatten(v, f"{prefix}.{name}")
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
        out = {k: _unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
        return {k: out[k] for k in skeleton}
    if _is_namedtuple(skeleton):
        return type(skeleton)(*(_unflatten(v, leaves) for v in skeleton))
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return next(leaves)


# a bfloat16 leaf is stored as the reference stores one (NumPy has no
# bfloat16: ml_dtypes' arrays are written as 2-byte records, '<V2', with
# "bfloat16" in meta.json), so the files are byte for byte the reference's
_BF16_DESCR = "<V2"


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        # a copy even on the CPU: the trainer updates its tensors in place
        # while an async save is still writing the captured arrays
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_DESCR)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(v: np.ndarray) -> str:
    return "bfloat16" if v.dtype == np.dtype(_BF16_DESCR) else str(v.dtype)


def _save_leaf(path: str, v: np.ndarray) -> None:
    if v.dtype != np.dtype(_BF16_DESCR):
        np.save(path, v)
        return
    with open(path, "wb") as f:  # np.save would write the record as '|V2'
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": v.shape})
        f.write(np.ascontiguousarray(v).tobytes())


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":  # the 2-byte records of a bfloat16 leaf
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


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


def _meta(step: int, extras: Optional[dict], leaves) -> dict:
    """meta.json of ``leaves``: ``(key, shape, dtype name)`` in file order."""
    return {
        "step": step,
        "extras": extras or {},
        "leaves": [
            {"key": key, "file": f"h0_l{idx:04d}.npy", "shape": list(shape), "dtype": dtype}
            for idx, (key, shape, dtype) in enumerate(leaves)
        ],
        "treedef": None,  # structure is re-derived from the restore skeleton
        "time": time.time(),
    }


def _stage(base: str, step: int) -> str:
    """A fresh staging directory for ``step`` (old debris removed first)."""
    tmp = _step_dir(base, step) + ".tmp"
    _gc_uncommitted(base)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    return tmp


def _commit(base: str, step: int, tmp: str, meta: dict, keep_last: int) -> None:
    _crash_point("meta")
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    _crash_point("commit")
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    _crash_point("replace")
    d = _step_dir(base, step)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    _prune(base, keep_last)


def save_checkpoint(
    base: str,
    step: int,
    tree: Any,
    *,
    extras: Optional[dict] = None,
    blocking: bool = True,
    keep_last: int = 3,
    shardings: Any = None,
) -> threading.Thread | None:
    """Capture ``tree`` on the host and persist it for ``step``. With
    ``shardings`` (the ``Blocks`` of every leaf of ``tree``, which holds this
    rank's blocks) every rank calls this; it gathers each leaf whole to rank
    0 and writes it there, blocking (the gathers are collectives)."""
    if shardings is not None:
        if not blocking:
            raise ValueError("save_checkpoint: a tree in blocks is saved blocking (its gathers "
                             "are collectives)")
        _save_blocks(base, step, tree, shardings, extras, keep_last)
        return None
    flat = [(key, _to_host(v)) for key, v in _flatten(tree)]
    meta = _meta(step, extras, [(key, v.shape, _dtype_name(v)) for key, v in flat])

    def write():
        tmp = _stage(base, step)
        for idx, (_, v) in enumerate(flat):
            _crash_point("array", idx)
            _save_leaf(os.path.join(tmp, f"h0_l{idx:04d}.npy"), v)
        _commit(base, step, tmp, meta, keep_last)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _save_blocks(base, step, tree, shardings, extras, keep_last):
    flat, blocks = _flatten(tree), [b for _, b in _flatten(shardings)]
    if len(flat) != len(blocks):
        raise ValueError(f"save_checkpoint: {len(flat)} leaves, {len(blocks)} shardings")
    mesh = blocks[0].mesh
    lead = mesh.rank == 0
    tmp = _stage(base, step) if lead else None
    leaves = []
    for idx, ((key, v), b) in enumerate(zip(flat, blocks)):
        if tuple(v.shape) != b.block_shape:
            raise ValueError(f"save_checkpoint: {key} holds {tuple(v.shape)}, its block is "
                             f"{b.block_shape}")
        leaves.append((key, b.shape, _dtype_name(_to_host(v.reshape(-1)[:0]))))
        if not b.owner():
            continue  # a copy of a block its first holder sends
        whole = b.gather_first(v)
        if lead:
            _crash_point("array", idx)
            _save_leaf(os.path.join(tmp, f"h0_l{idx:04d}.npy"), _to_host(whole))
        del whole
    mesh.barrier()
    if lead:
        _commit(base, step, tmp, _meta(step, extras, leaves), keep_last)
    mesh.barrier()


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
    base: str, skeleton: Any, *, step: Optional[int] = None, in_place: bool = False,
    shardings: Any = None,
) -> tuple[Any, int, dict]:
    """Restore into the structure of ``skeleton`` (a tree whose leaves have
    ``shape`` and ``dtype``: numpy arrays or torch tensors). Each leaf's
    shape is checked; it comes back in the skeleton leaf's dtype — a torch
    tensor on the skeleton leaf's device, else a numpy array. With
    ``in_place`` every torch leaf of the skeleton is overwritten (``copy_``)
    and is itself the restored leaf, so a device never holds two copies of
    the state. With ``shardings`` (a tree of ``sharding.process.Blocks``
    shaped like ``skeleton``) each leaf is this rank's block of the saved
    leaf, whatever mesh saved it, read from the file in place (the
    skeleton's leaves are blocks). Returns ``(tree, step, extras)``."""
    d, step, meta = _read_meta(base, step)
    by_key = {leaf["key"]: leaf for leaf in meta["leaves"]}
    flat = _flatten(skeleton)
    blocks = [None] * len(flat) if shardings is None else [b for _, b in _flatten(shardings)]
    if len(blocks) != len(flat):
        raise ValueError(f"restore_checkpoint: {len(flat)} leaves, {len(blocks)} shardings")
    out = []
    for (key, leaf), b in zip(flat, blocks):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        path = os.path.join(d, by_key[key]["file"])
        if b is None:
            arr = np.load(path)
        else:
            arr = np.load(path, mmap_mode="r")
            if tuple(arr.shape) != b.shape:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {b.shape}")
            arr = np.array(arr[b.index()])  # this rank's block alone, copied
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            t = _from_host(arr, by_key[key]["dtype"])
            out.append(leaf.copy_(t) if in_place else t.to(device=leaf.device, dtype=leaf.dtype))
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
    """Step-cadenced async checkpointing with a single in-flight writer; a
    tree in blocks (``shardings``) is saved blocking, by every rank."""

    def __init__(self, base: str, every: int = 100, keep_last: int = 3, shardings: Any = None):
        self.base = base
        self.every = every
        self.keep_last = keep_last
        self.shardings = shardings
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(base, exist_ok=True)

    def maybe_save(self, step: int, tree, extras=None, force=False):
        if not force and (step % self.every != 0):
            return False
        self.wait()
        self._inflight = save_checkpoint(
            self.base, step, tree, extras=extras, blocking=self.shardings is not None,
            keep_last=self.keep_last, shardings=self.shardings,
        )
        return True

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
