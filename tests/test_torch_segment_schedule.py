"""The fixed-order scatter's blocks (``ops.segment_index``'s ``blk_seg``).

On the card ``csrc/segment_add.cu`` runs one block per run of whole
segments, each of at most ``BLOCK_ROWS`` rows and ``BLOCK_SEGS`` segments
(a longer segment alone), grouped on the host once per pack. Here, on the
layouts the flushes give it and on the block-boundary cases:

* every segment lies in exactly one block, blocks are in lixel order and
  none splits a segment; a block holds at most ``BLOCK_ROWS`` rows unless it
  is one segment; each block is as full as the limits let it be;
* the block count is the host int the wrapper launches with, and the same
  ``(lixel, slots)`` always gives the same fields;
* the module's limits are the kernel source's constants;
* ``ops.segment_add`` on the CPU is bitwise the sequential scatter of the
  rows in atom order on the same layouts.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import segment_add as sa
from test_torch_scatter_order import _sequential
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

R = sa.BLOCK_ROWS
LAYOUTS = ["duplicates", "padded", "single", "empty", "long", "ramp"]


def _layout(name, rng, *, ramp_step=1):
    """(lixel [M], slots [M], n_src) of one index layout."""
    if name == "duplicates":  # every row real, many per lixel
        lixel = rng.integers(0, 40, 3000)
        return lixel, np.arange(3000), 3000
    if name == "padded":  # a grouped layout: only some slots hold real atoms
        slots = np.sort(rng.choice(2000, 900, replace=False))
        return rng.integers(0, 300, 900), slots, 2000
    if name == "single":  # one segment holding every row
        return np.full(50, 11), rng.permutation(120)[:50], 120
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 10
    if name == "long":  # one segment of 5 000 rows among short ones
        lixel = np.concatenate([np.full(5000, 50), rng.integers(0, 35, 300)])
        rng.shuffle(lixel)
        return lixel, rng.permutation(5400)[:5300], 5400
    # a ramp of segment lengths 1 .. 2R+1 (every ramp_step-th), shuffled into
    # atom order, on padded slots
    lens = np.arange(1, 2 * R + 2, ramp_step)
    lixel = np.repeat(rng.permutation(len(lens)) * 2, lens)
    rng.shuffle(lixel)
    n_src = len(lixel) + 97
    return lixel, np.sort(rng.choice(n_src, len(lixel), replace=False)), n_src


def test_block_limits_are_the_kernel_source_constants():
    src = (Path(sa.__file__).parent / "csrc" / "segment_add.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = (\w+)\s*(?:/\s*(\w+))?;", src).groups()

    assert const("BLOCK_ROWS") == (str(sa.BLOCK_ROWS), None)
    assert const("TILE_COLS") == (str(sa.TILE_COLS), None)
    assert const("BLOCK_SEGS") == ("THREADS", "TILE_COLS")
    threads = int(const("THREADS")[0])
    assert sa.BLOCK_SEGS == threads // sa.TILE_COLS


@pytest.mark.parametrize("layout", LAYOUTS)
def test_blocks_hold_whole_segments_in_lixel_order(layout):
    lixel, slots, n_src = _layout(layout, np.random.default_rng(len(layout)))
    index = ops.segment_index(lixel, slots, device="cpu")
    ptr, blk = index.seg_ptr.numpy(), index.blk_seg.numpy()
    U = index.n_segs
    assert blk.dtype == np.int64 and blk[0] == 0 and blk[-1] == U
    assert np.all(np.diff(blk) > 0), "an empty block, or blocks out of lixel order"
    assert index.n_blocks == len(blk) - 1
    assert np.array_equal(index.blk_row.numpy(), ptr[blk]), "blk_row is not seg_ptr[blk_seg]"
    segs = np.diff(blk)
    rows = ptr[blk[1:]] - ptr[blk[:-1]]
    assert np.all(segs <= sa.BLOCK_SEGS)
    assert np.all((rows <= R) | (segs == 1)), "a block of several segments over BLOCK_ROWS"
    # greedy: a block stops only where the next segment would break a limit
    nxt = np.diff(ptr)[blk[1:-1]]
    assert np.all((rows[:-1] + nxt > R) | (segs[:-1] == sa.BLOCK_SEGS))
    # the grid the wrapper launches with is the index's host block count
    heat = torch.zeros((int(lixel.max(initial=0)) + 1, 5), dtype=torch.float64)
    args = sa.segment_add_args(heat, torch.zeros((n_src, 5), dtype=torch.float64), index)
    assert args.n_blocks == index.n_blocks
    assert (args.block_rows, args.block_segs) == (sa.BLOCK_ROWS, sa.BLOCK_SEGS)
    assert args[5:11] == (0, *(getattr(index, k).data_ptr() for k in
                               ("rows", "seg_ptr", "lixel", "blk_seg", "blk_row")))
    # the same (lixel, slots) gives the same fields
    again = ops.segment_index(lixel.copy(), slots.copy(), device="cpu")
    for name in ("rows", "seg_ptr", "lixel", "blk_seg", "blk_row"):
        assert torch.equal(getattr(index, name), getattr(again, name)), name
    assert (again.n_blocks, again.max_len, again.src_rows) == (
        index.n_blocks, index.max_len, index.src_rows)
    if layout == "long":
        assert index.max_len == 5000 and 5000 in rows.tolist()
    if layout == "ramp":
        assert index.max_len == 2 * R + 1 and index.n_blocks > 2 * R // sa.BLOCK_SEGS


@pytest.mark.parametrize("W", [1, 5, 16])
@pytest.mark.parametrize("halves", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_add_is_a_sequential_scatter_on_block_layouts(W, halves, layout):
    rng = np.random.default_rng(W * 10 + halves + 100 * len(layout))
    lixel, slots, n_src = _layout(layout, rng, ramp_step=37)  # 28 segments of the ramp
    C = 2 * W if halves else W
    src = torch.as_tensor(rng.normal(size=(n_src, C)) * 10.0 ** rng.integers(-8, 8, (n_src, 1)))
    heat = torch.as_tensor(rng.normal(size=(int(lixel.max(initial=0)) + 3, W)))
    index = ops.segment_index(lixel, slots, device="cpu")
    want = _sequential(heat, src, lixel, slots, halves)
    assert torch.equal(ops.segment_add(heat.clone(), src, index, halves=halves), want)
    got_t = ops.segment_add(heat.clone(), src.T.contiguous().T, index, halves=halves)
    assert torch.equal(got_t, want)
