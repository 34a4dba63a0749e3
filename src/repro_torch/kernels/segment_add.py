"""Fixed-order scatter of a flush's per-atom rows onto the [L, W] heatmap.

Every flush of every executor ends by adding its atoms' rows (one row per
atom, one column per window) onto the heatmap rows of their lixels. The
order of those additions decides the bits of the answer, so it is fixed
here, once per atom pack and independent of any window: the pack's real
rows are stably sorted by lixel (:func:`segment_index`), and each (unique
lixel, window column) adds its rows in plan order onto the heatmap's
value, one rounding per add. The answer for a window therefore does not
depend on the flush's width, its batchmates or the PyTorch release, and
equals a sequential scatter of the rows in atom order.

``csrc/segment_add.cu`` computes it on the card. Each (lixel, column) stays
one serial chain, as the order requires; what runs in parallel is the loads
that feed the chains. :func:`segment_index` also groups consecutive whole
segments into blocks of at most :data:`BLOCK_ROWS` rows and
:data:`BLOCK_SEGS` segments (a longer segment is a block of its own), once
per pack on the host; each block of the kernel stages its rows' values in
shared memory a tile at a time, all loads in flight together, and then runs
its chains out of shared memory. The lixels of one call are unique, so
there are no atomics. It was added by the port and has no TPU counterpart.
This module holds the segment index, the plain PyTorch version
(:func:`segment_add_ref`: a loop over the k-th row of every segment at once,
the same additions in the same order, so on the card it is bitwise the
kernel's), the kernel's arguments (:func:`segment_add_args`) and the
``ctypes`` binding. The launching wrapper, with its checks and launch
count, is :func:`repro_torch.kernels.ops.segment_add`.
"""
from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["BLOCK_ROWS", "BLOCK_SEGS", "TILE_COLS", "SegmentIndex", "segment_index",
           "segment_add_ref", "SegmentArgs", "segment_add_args", "segment_add_library"]

# the block limits of csrc/segment_add.cu (its constants of the same names;
# the kernel refuses an index built with others)
BLOCK_ROWS = 512  # rows of a block unless it is one longer segment; rows of a tile
TILE_COLS = 8  # source columns of a tile (8 windows, or 4 half-window pairs)
BLOCK_SEGS = 32  # segments of a block: one chain per (segment, column) thread


class SegmentIndex(NamedTuple):
    """One atom pack's rows grouped by lixel, in plan order within a lixel.

    ``rows [M]`` the source row of each real row (sorted by lixel, stable),
    ``seg_ptr [U+1]`` the CSR bounds of each unique lixel's rows in ``rows``,
    ``lixel [U]`` the unique lixels, ``blk_seg [B+1]`` the kernel's blocks
    (block b owns the whole segments ``blk_seg[b] .. blk_seg[b+1]``: at most
    :data:`BLOCK_ROWS` rows and :data:`BLOCK_SEGS` segments, or one longer
    segment) and ``blk_row [B+1]`` their first rows (``seg_ptr[blk_seg]``),
    all int64 on the pack's device; the host ints are the longest
    segment (the plain version's trip count), one past the largest source
    row (what the wrapper checks the source's row count against, without
    reading the card) and the block count B (the kernel's grid); ``ptrs``
    the device pointers of the five tensors, read once here so that a
    launch spends no host work on them."""

    rows: torch.Tensor
    seg_ptr: torch.Tensor
    lixel: torch.Tensor
    blk_seg: torch.Tensor
    blk_row: torch.Tensor
    max_len: int
    src_rows: int
    n_blocks: int
    ptrs: tuple

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_segs(self) -> int:
        return int(self.lixel.shape[0])


def segment_blocks(ptr) -> np.ndarray:
    """``blk_seg [B+1]`` of the CSR bounds ``ptr [U+1]``: consecutive whole
    segments, greedily as many as fit in :data:`BLOCK_ROWS` rows and
    :data:`BLOCK_SEGS` segments; a segment longer than that alone."""
    p = np.asarray(ptr, np.int64).tolist()
    U = len(p) - 1
    out, s = [0], 0
    while s < U:
        e = bisect.bisect_right(p, p[s] + BLOCK_ROWS, s + 1, min(s + BLOCK_SEGS, U) + 1) - 1
        s = max(e, s + 1)
        out.append(s)
    return np.asarray(out, np.int64)


def segment_index(lixel, slots=None, *, device) -> SegmentIndex:
    """The :class:`SegmentIndex` of a pack from host arrays: ``lixel [M]`` the
    lixel of each real row in plan order, ``slots [M]`` the row of the flush's
    output that holds it (default: row m). Padding rows are simply not
    listed: they belong to no segment. Host work only; the uploads do not
    wait for the card."""
    lixel = np.asarray(lixel, np.int64).reshape(-1)
    slots = (np.arange(len(lixel), dtype=np.int64) if slots is None
             else np.asarray(slots, np.int64).reshape(-1))
    if slots.shape != lixel.shape:
        raise ValueError(f"segment_index: {slots.shape[0]} slots for {lixel.shape[0]} lixels")
    order = np.argsort(lixel, kind="stable")
    uniq, start = np.unique(lixel[order], return_index=True)
    ptr = np.append(start, len(lixel)).astype(np.int64)
    blk = segment_blocks(ptr)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64)).to(device, non_blocking=True)

    t = dict(rows=up(slots[order]), seg_ptr=up(ptr), lixel=up(uniq), blk_seg=up(blk),
             blk_row=up(ptr[blk]))
    return SegmentIndex(**t, max_len=int(np.diff(ptr).max(initial=0)),
                        src_rows=int(slots.max(initial=-1)) + 1, n_blocks=len(blk) - 1,
                        ptrs=tuple(v.data_ptr() for v in t.values()))


def segment_add_ref(heat: torch.Tensor, src: torch.Tensor, index: SegmentIndex, *,
                    halves: bool = False) -> torch.Tensor:
    """``heat[lixel[u], w] += Σ_i x(rows[i], w)`` over each segment, in plan
    order, in place; returns ``heat``. ``src [N, C]`` float64 (any strides)
    holds the rows; ``x(r, w) = src[r, w]``, or with ``halves`` (C = 2W, the
    half-window row order) ``src[r, 2w] + src[r, 2w + 1]``. Plain PyTorch:
    trip k adds the k-th row of every segment that has one, all segments and
    columns at once."""
    if index.n_rows == 0 or heat.shape[1] == 0:
        return heat
    v = src.index_select(0, index.rows)  # [M, C] in segment order
    if halves:
        v = v[:, 0::2] + v[:, 1::2]
    start = index.seg_ptr[:-1]
    length = index.seg_ptr[1:] - start
    acc = heat.index_select(0, index.lixel)  # [U, W]
    last = index.n_rows - 1
    for k in range(index.max_len):
        row = v.index_select(0, (start + k).clamp_max(last))
        acc = torch.where((k < length)[:, None], acc + row, acc)
    heat.index_copy_(0, index.lixel, acc)
    return heat


class SegmentArgs(NamedTuple):
    """The arguments of ``segment_add_f64`` but the device and the stream, in
    the C order (host ints: pointers, strides in elements, the grid)."""

    heat: int
    ldh: int
    src: int
    ld: int
    cs: int
    hs: int
    rows: int
    seg_ptr: int
    lixel: int
    blk_seg: int
    blk_row: int
    n_blocks: int
    block_rows: int
    block_segs: int
    W: int


def segment_add_args(heat: torch.Tensor, src: torch.Tensor, index: SegmentIndex, *,
                     halves: bool = False) -> SegmentArgs:
    """The kernel's arguments for a contiguous ``heat [L, W]``: a window's
    source column ``cs`` apart, a half-window pair's two ``hs`` apart (0
    without pairs), and the grid, the index's host block count. No read of
    the card, and no host work per index tensor."""
    ld, sc = src.stride()
    W = heat.shape[1]
    return SegmentArgs(heat.data_ptr(), W, src.data_ptr(), ld, 2 * sc if halves else sc,
                       sc if halves else 0, *index.ptrs, index.n_blocks, BLOCK_ROWS, BLOCK_SEGS,
                       W)


def segment_add_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/segment_add.cu``, built at first use, with the
    argument types of ``segment_add_f64`` set."""
    from ._build import load_library

    lib = load_library("segment_add", verbose=verbose)
    fn = lib.segment_add_f64
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll, p, ll, ll, ll, p, p, p, p, p, ll, i, i, i, i, p]
        fn.restype = i
    return lib
