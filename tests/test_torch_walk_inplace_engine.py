"""The executors that launch the in-place walk and leaf kernels, on the CPU
(``device='cpu'``: each kernel's plain version): ``fused`` for RFS and both
DRFS modes, ``kernel`` for exact DRFS (its quantized mode is held in
``tests/test_torch_leaf_inplace.py``) stay within 1e-12 of
``executor='packed'`` and of the reference's ``engine='numpy'``, duplicate
window centres bitwise, and no grouped copy is cached; the kernel gets the
cached window table itself (a view: the quantized leaf table is built
contiguous), and ``device_bytes`` counts a tensor that a pack's index shares
once. (Moved unchanged from ``tests/test_torch_walk_inplace.py``, which
keeps the kernel-level tests.)
"""
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 11 * 86400.0, 4 * 86400.0]  # one duplicate
N_BASE, N_INS = 700, 100  # the insert stays pending
FAMILIES = [("triangular", "quartic"), ("gaussian", "triangular")]


def _sorted_world(mod):
    net = mod.make_network(60, 100, seed=13)
    ev = mod.make_events(net, 800, seed=14, span_days=12)
    o = np.argsort(ev.time, kind="stable")
    return net, (ev.edge_id[o], ev.pos[o], ev.time[o])


@pytest.fixture(scope="module")
def worlds():
    return _sorted_world(port_spatial), _sorted_world(ref_spatial)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("ks,kt", FAMILIES)
def test_rfs_fused_matches_packed_and_reference(worlds, ks, kt):
    (net, ev), (rnet, rev) = worlds
    kw = dict(solution="rfs", spatial_kernel=ks, temporal_kernel=kt, **KW)
    want = RefTNKDE(rnet, RefEvents(*rev), engine="numpy", **kw).query(TS5)
    packed = TNKDE(net, Events(*ev), engine="torch", executor="packed", device="cpu",
                   **kw).query(TS5)
    m = TNKDE(net, Events(*ev), engine="torch", executor="fused", device="cpu", **kw)
    got = m.query(TS5)
    assert np.abs(want).max() > 0
    assert _rel(got, packed) <= 1e-12 and _rel(got, want) <= 1e-12
    assert np.array_equal(got[1], got[4])
    assert np.array_equal(m.query(TS5), got)  # warm == cold
    # every pack carries its range-checked index; no grouped copy is kept
    packs = m._fe._atom_packs(m._host_plan())
    assert all(e["index"].rows <= m._fe.window_tables(
        m._fe.window_batch(m.ctx, TS5), tuple(TS5)).shape[0] for e in packs)
    assert not hasattr(m._fe, "_group_cache")


@pytest.mark.parametrize("executor,exact", [("fused", False), ("fused", True), ("kernel", True)])
@pytest.mark.parametrize("ks,kt", FAMILIES)
def test_drfs_in_place_matches_packed_and_reference(worlds, ks, kt, executor, exact):
    (net, ev), (rnet, rev) = worlds
    kw = dict(solution="drfs", drfs_depth=5, drfs_exact_leaf=exact, spatial_kernel=ks,
              temporal_kernel=kt, **KW)
    ref = RefTNKDE(rnet, RefEvents(*(a[:N_BASE] for a in rev)), engine="numpy", **kw)
    ref.insert(RefEvents(*(a[N_BASE:N_BASE + N_INS] for a in rev)))
    want = ref.query(TS5)
    got = {}
    for ex in ("packed", executor):
        m = TNKDE(net, Events(*(a[:N_BASE] for a in ev)), engine="torch", executor=ex,
                  device="cpu", **kw)
        m.insert(Events(*(a[N_BASE:N_BASE + N_INS] for a in ev)))
        got[ex] = m.query(TS5)
        assert np.array_equal(m.query(TS5), got[ex])  # warm == cold
    F = got[executor]
    assert np.abs(want).max() > 0
    assert _rel(F, got["packed"]) <= 1e-12 and _rel(F, want) <= 1e-12
    assert np.array_equal(F[1], F[4])
    # the in-place paths keep no grouped copy; each block's index is built once
    assert not hasattr(m._fe, "_group_cache")
    for entry in m._fe._atom_packs(m._host_plan(m.snapshot())):
        assert list(entry["index"]) == [(5, exact)]


def test_device_bytes_count_a_shared_tensor_once(worlds):
    """A pack's FlatIndex holds the pack's edges and the engine's node bases:
    ``device_bytes`` counts each tensor once."""
    from repro_torch.core.rfs import _device_nbytes

    (net, ev), _ = worlds
    m = TNKDE(net, Events(*ev), solution="rfs", engine="torch", executor="fused",
              device="cpu", **KW)
    m.query(TS5[:2])
    fe = m._fe
    entry = fe._atom_packs(m._host_plan())[0]
    assert _device_nbytes([entry, entry["index"], entry["edges"]]) == _device_nbytes(entry)
    base = fe._packed["node_base_lvl"]
    assert _device_nbytes([base, base, entry["index"]]) == (base.numel() + entry["edges"].numel()) * 8


@pytest.mark.parametrize("exact", [False, True])
def test_drfs_kernels_get_the_cached_window_table_in_place(worlds, exact):
    """The table a flush hands the kernel shares storage with the cached
    window table (a view, no copy): the quantized leaf table is built
    contiguous, so viewing it as [rows, W·2K] copies nothing."""
    (net, ev), _ = worlds
    m = TNKDE(net, Events(*(a[:N_BASE] for a in ev)), solution="drfs", engine="torch",
              executor="fused", device="cpu", drfs_depth=5, drfs_exact_leaf=exact, **KW)
    m.query(TS5)
    fe, snap = m._fe, m.snapshot()
    (tables,) = [t for k, t in fe._tab_cache.items() if k[4] == exact]
    assert tables[0].is_contiguous()
    entry = fe._atom_packs(m._host_plan(snap))[0]
    tab, index = fe.tree_table(tables, entry, hq=snap.depth, exact=exact)
    assert tab.dim() == 2 and tab.data_ptr() == tables[0].data_ptr()
    assert index.rows <= tab.shape[0]


@pytest.mark.parametrize("executor", ["fused", "kernel"])
def test_drfs_keeps_no_grouped_copy(worlds, executor):
    """Neither kernel executor keeps a grouped copy of a window table in
    either mode: the kernel executor's quantized mode (dyn_leaf_query_flat)
    reads the leaf table in place as the fused one does, and both hold the
    same device bytes."""
    (net, ev), _ = worlds
    kw = dict(solution="drfs", engine="torch", device="cpu", drfs_depth=5, **KW)
    models = [TNKDE(net, Events(*(a[:N_BASE] for a in ev)), executor=ex, **kw)
              for ex in (executor, "fused")]
    for exact in (True, False):
        for m in models:
            m.drfs_exact_leaf = exact
            m.query(TS5)
    m = models[0]
    assert not hasattr(m._fe, "_group_cache")
    assert m._fe.device_bytes == models[1]._fe.device_bytes
    snap = m.snapshot()
    for entry in m._fe._atom_packs(m._host_plan(snap)):
        assert sorted(entry["index"]) == [(5, False), (5, True)]
