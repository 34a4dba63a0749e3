"""The fixed-order scatter (``ops.segment_add``) on the CPU.

Every flush of every executor ends in it, so a window's answer must not
depend on the flush it rode in:

* a window answered alone is bitwise the same window answered in a W = 5
  flush, and a warm query bitwise the cold one, for every RFS executor
  (packed, fused, kernel, search, cascade) and every DRFS executor (packed,
  fused, kernel) in both modes, with pending events live;
* the plain version (what a CPU tensor gets, and what the kernel is held
  against bitwise on the card) is bitwise a sequential Python loop that adds
  the rows in atom order, over odd widths, half-window pairs, empty and
  single segments and padded slots.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.data.spatial import make_events, make_network
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=50.0, b_s=600.0, b_t=2.0 * 86400.0)
TS5 = [2.5 * 86400.0, 4.0 * 86400.0, 6.0 * 86400.0, 8.0 * 86400.0, 4.0 * 86400.0]


@pytest.fixture(scope="module")
def world():
    net = make_network(36, 60, seed=31)
    return net, make_events(net, 420, seed=32, span_days=10)


def _split(ev, lo, hi):
    order = np.argsort(ev.time, kind="stable")[lo:hi]
    return Events(ev.edge_id[order], ev.pos[order], ev.time[order])


CASES = [("rfs", None, ex) for ex in ("packed", "fused", "kernel", "search", "cascade")] + [
    ("drfs", mode, ex) for mode in ("quantized", "exact") for ex in ("packed", "fused", "kernel")
]


@pytest.mark.parametrize("solution,mode,executor", CASES)
def test_window_alone_equals_window_in_wider_flush(world, solution, mode, executor):
    net, ev = world
    kw = dict(KW)
    if solution == "drfs":
        kw.update(drfs_depth=4, drfs_exact_leaf=(mode == "exact"), auto_seal=False)
        base = _split(ev, 0, 360)
    else:
        base = ev
    m = TNKDE(net, base, solution=solution, engine="torch", executor=executor, device="cpu",
              **kw)
    if solution == "drfs":
        m.insert(_split(ev, 360, 420))  # pending events: the scan phase adds rows too
    F = m.query(TS5)
    assert np.abs(F).max() > 0
    assert np.array_equal(m.query(TS5), F), "warm query differs from the cold one"
    assert np.array_equal(F[1], F[4]), "duplicate centres differ"
    for w, t in enumerate(TS5):
        alone = m.query([t])
        assert np.array_equal(alone[0], F[w]), f"window {w} alone differs from its W=5 flush"


def _sequential(heat, src, lixel, slots, halves):
    """heat[lixel[m]] += x(slots[m]) one row at a time, in atom order."""
    out = heat.clone()
    for lx, r in zip(lixel.tolist(), slots.tolist()):
        row = src[r]
        if halves:
            row = row[0::2] + row[1::2]
        out[lx] = out[lx] + row
    return out


@pytest.mark.parametrize("W", [1, 5, 16])
@pytest.mark.parametrize("halves", [False, True])
@pytest.mark.parametrize("layout", ["duplicates", "padded", "single", "empty"])
def test_plain_segment_add_is_a_sequential_scatter(W, halves, layout):
    rng = np.random.default_rng(W * 10 + halves)
    L = 37
    n_src = 120
    C = 2 * W if halves else W
    src = torch.as_tensor(rng.normal(size=(n_src, C)) * 10.0 ** rng.integers(-8, 8, (n_src, 1)))
    if layout == "duplicates":  # every row real, many per lixel
        slots = np.arange(n_src)
        lixel = rng.integers(0, L // 3, n_src)
    elif layout == "padded":  # a grouped layout: only some slots hold real atoms
        slots = np.sort(rng.choice(n_src, 70, replace=False))
        lixel = rng.integers(0, L, len(slots))
    elif layout == "single":  # one segment holding every row
        slots = rng.permutation(n_src)[:50]
        lixel = np.full(len(slots), 11)
    else:  # no rows at all
        slots = np.zeros(0, np.int64)
        lixel = np.zeros(0, np.int64)
    heat = torch.as_tensor(rng.normal(size=(L, W)))
    index = ops.segment_index(lixel, slots, device="cpu")
    want = _sequential(heat, src, lixel, slots, halves)
    got = ops.segment_add(heat.clone(), src, index, halves=halves)
    assert torch.equal(got, want)
    # a transposed (strided) source, as the plain executors hand it over
    got_t = ops.segment_add(heat.clone(), src.T.contiguous().T, index, halves=halves)
    assert torch.equal(got_t, want)
    if len(lixel):
        assert index.max_len == np.bincount(lixel).max()
        assert index.n_segs == len(np.unique(lixel))
