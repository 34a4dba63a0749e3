"""The fused walk and leaf kernels reading the flat window tables in place, on
the CPU.

``fused_walk_flat_ref`` and ``fused_leaf_flat_ref`` (the plain versions the
in-place CUDA kernels are held against on the card) read a flat table through
a ``FlatIndex``: walk level ℓ of an atom on edge e reads row
``(lvl_base[ℓ, e] + node)·2 + side``; a leaf phase reads rows
``e·(nleaf+1)·2 + leaf·2 + side``. They must be

* bitwise equal to the grouped plain versions (``fused_walk_ref``,
  ``fused_leaf_ref``) on a grouped copy that each test builds itself from the
  flat table (the copy the flush no longer makes);
* within 1e-12 relative to max|want| of ``repro.kernels.ref`` and the Pallas
  kernels in interpret mode on that copy (float64; only the association of
  the addends differs).

The executors that now launch them — ``fused`` for RFS and both DRFS modes,
``kernel`` for exact DRFS (its quantized mode is held in
``tests/test_torch_leaf_inplace.py``) — stay within 1e-12 of
``executor='packed'`` and of the reference's ``engine='numpy'``, duplicate
window centres bitwise, and no
grouped copy is cached; the kernel gets the cached window table itself (a
view: the quantized leaf table is built contiguous), and ``device_bytes``
counts a tensor that a pack's index shares once. The wrappers take the plain
versions on the CPU
(counting no launch) and raise off the CPU when the pack's rows lie beyond
the table; the index builders raise on out-of-range edges or bases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.core.torch_engine import dyn_node_base
from repro_torch.kernels import ops
from repro_torch.kernels.dyn_query import tree_offs
from repro_torch.kernels.fused_walk import (
    fused_leaf_flat_ref,
    fused_leaf_ref,
    fused_walk_flat_ref,
    fused_walk_ref,
    leaf_index,
    walk_index,
)

# (layout, edges E, groups G, ragged Q, windows W, k_s); W = 9 > 8 windows
WALK_CASES = [
    ("rfs4", 5, 4, 7, 1, 2), ("rfs8", 5, 4, 33, 2, 3), ("rfs16", 6, 3, 65, 3, 2),
    ("rfs64", 4, 3, 130, 9, 2),
    ("tree2", 5, 4, 7, 1, 2), ("tree3", 5, 3, 33, 9, 3), ("tree4", 6, 3, 65, 2, 2),
]
# (nleaf, E, G, Q, W, k_s, k_t)
LEAF_CASES = [(4, 5, 4, 7, 1, 2, 2), (8, 5, 3, 33, 3, 3, 2), (16, 6, 3, 65, 9, 2, 3)]


def _walk_case(layout, E, G, Q, W, ks):
    """A flat level-major table of E edges with one npad ('rfs<npad>': the
    packed forest's node order; 'tree<hq>': dyn_node_tables'), G groups on
    edges drawn with repeats, every fifth slot padding. Returns the flat
    arguments, and the grouped copy's block order [(walk level, nodes)] and
    static offsets."""
    n = int(layout.lstrip("rfstre"))
    if layout.startswith("rfs"):
        npad = n
        nlev = npad.bit_length()
        e = torch.arange(E)
        lvl_base = torch.stack([E * (2 * npad - 2 * (npad >> lev)) + e * (npad >> lev)
                                for lev in range(nlev)])
        order = [(lev, npad >> lev) for lev in range(nlev)]
        offs = tuple(sum(npad >> j for j in range(lev)) for lev in range(nlev))
    else:
        npad = 1 << n
        lvl_base = dyn_node_base(E, n)
        order = [(n - d, 1 << d) for d in range(n + 1)]  # depths 0..hq stacked
        offs = tree_offs(n)
    rng = np.random.default_rng(npad * 1000 + E * 10 + Q)
    table = torch.as_tensor(rng.normal(size=(2 * E * (2 * npad - 1), W * 2 * ks)))
    edges = torch.as_tensor(rng.integers(0, E, G))
    r_lo = rng.integers(0, npad + 1, (G, Q))
    r_hi = np.maximum(rng.integers(0, npad + 1, (G, Q)), r_lo)
    r_hi[:, ::5] = r_lo[:, ::5]
    qs = rng.normal(size=(G, Q, ks))
    qs[:, ::5] = 0.0
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    args = (table, walk_index(lvl_base, edges, npad), i32(r_lo), i32(r_hi),
            i32(rng.integers(0, 2, (G, Q))), torch.as_tensor(qs))
    return args, order, offs


def _walk_grouped(args, order):
    """The per-edge grouped copy [G, R2, W·2k_s] of the flat table."""
    table, index = args[0], args[1]
    parts = []
    for lev, nodes in order:
        rows = index.lvl_base[lev][index.edges][:, None] * 2 + torch.arange(2 * nodes)[None]
        parts.append(table[rows])
    return torch.cat(parts, dim=1)


def _leaf_case(nleaf, E, G, Q, W, ks, kt):
    rng = np.random.default_rng(nleaf * 1000 + E * 10 + Q)
    R = (nleaf + 1) * 2
    lcum = np.cumsum(rng.normal(size=(E, R, W * 2 * ks * kt)), axis=1).reshape(E * R, -1)
    edges = torch.as_tensor(rng.integers(0, E, G))
    lo = rng.integers(0, nleaf + 1, (G, Q))
    hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), lo)
    hi[:, ::5] = lo[:, ::5]
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    return (torch.as_tensor(lcum), leaf_index(edges, nleaf), i32(lo), i32(hi),
            i32(rng.integers(0, 2, (G, Q))), torch.as_tensor(rng.normal(size=(G, Q, ks))),
            torch.as_tensor(rng.normal(size=(W, kt))), torch.as_tensor(rng.normal(size=(W, kt))))


def _leaf_grouped(args):
    lcum, index = args[0], args[1]
    R = (index.span + 1) * 2
    return lcum.reshape(-1, R, lcum.shape[1])[index.edges]


# ------------------------------------------------------------ plain versions
@pytest.mark.parametrize("layout,E,G,Q,W,ks", WALK_CASES)
def test_flat_walk_ref_bitwise_equals_grouped_ref(layout, E, G, Q, W, ks):
    args, order, offs = _walk_case(layout, E, G, Q, W, ks)
    got = fused_walk_flat_ref(*args)
    want = fused_walk_ref(_walk_grouped(args, order), *args[2:], offs=offs)
    assert got.shape == (G, Q, W) and want.shape == (G, W, Q)
    assert torch.equal(got, want.permute(0, 2, 1))
    assert bool((got[:, ::5] == 0.0).all()) and bool((got != 0.0).any())


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("layout,E,G,Q,W,ks", WALK_CASES)
def test_flat_walk_ref_matches_reference(layout, E, G, Q, W, ks, oracle):
    """On the grouped copy: ``ref.fused_walk`` / the Pallas ``fused_walk``
    (RFS layouts), ``ref.dyn_node_walk`` / ``dyn_node_walk_pallas`` (trees)."""
    from repro.kernels.dyn_query import dyn_node_walk_pallas

    args, order, offs = _walk_case(layout, E, G, Q, W, ks)
    got = fused_walk_flat_ref(*args).permute(0, 2, 1).numpy()
    arrs = [_walk_grouped(args, order).numpy()] + [t.numpy() for t in args[2:]]
    hq = int(layout[4:]) if layout.startswith("tree") else None
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if hq is None and oracle == "ref":
            want = ref_oracle.fused_walk(*jargs, offs=offs)
        elif hq is None:
            want = ref_ops.fused_walk(*jargs, offs=offs, tq=32)
        elif oracle == "ref":
            want = ref_oracle.dyn_node_walk(*jargs, hq=hq)
        else:
            want = dyn_node_walk_pallas(*jargs, hq=hq, tq=32, interpret=True)
        want = np.asarray(want)
    assert want.dtype == np.float64 and got.shape == want.shape == (G, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("nleaf,E,G,Q,W,ks,kt", LEAF_CASES)
def test_flat_leaf_ref_bitwise_equals_grouped_ref(nleaf, E, G, Q, W, ks, kt):
    args = _leaf_case(nleaf, E, G, Q, W, ks, kt)
    got = fused_leaf_flat_ref(*args)
    want = fused_leaf_ref(_leaf_grouped(args), *args[2:])
    assert got.shape == (G, Q, W)
    assert torch.equal(got, want.permute(0, 2, 1))
    assert bool((got[:, ::5] == 0.0).all()) and bool((got != 0.0).any())


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("nleaf,E,G,Q,W,ks,kt", LEAF_CASES)
def test_flat_leaf_ref_matches_reference(nleaf, E, G, Q, W, ks, kt, oracle):
    args = _leaf_case(nleaf, E, G, Q, W, ks, kt)
    got = fused_leaf_flat_ref(*args).permute(0, 2, 1).numpy()
    arrs = [_leaf_grouped(args).numpy()] + [t.numpy() for t in args[2:]]
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if oracle == "ref":
            want = np.asarray(ref_oracle.fused_leaf(*jargs))
        else:
            want = np.asarray(ref_ops.fused_leaf(*jargs, tq=32))
    assert want.dtype == np.float64 and got.shape == want.shape == (G, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_flat_walk_window_independence():
    """Two windows with identical rows give bitwise identical outputs."""
    args, _, _ = _walk_case("rfs16", 6, 3, 65, 1, 2)
    table = torch.cat([args[0], args[0]], dim=1)  # W = 2, identical windows
    out = fused_walk_flat_ref(table, *args[1:])
    assert torch.equal(out[..., 0], out[..., 1])


# ------------------------------------------------------------------ wrappers
def test_wrappers_cpu_use_plain_versions_and_count_no_launch():
    wargs, _, _ = _walk_case("tree3", 5, 3, 33, 2, 3)
    largs = _leaf_case(8, 5, 3, 33, 3, 3, 2)
    names = ("fused_walk", "dyn_node_walk", "fused_leaf")
    before = {n: getattr(ops, n).launches for n in names}
    assert torch.equal(ops.fused_walk_flat(*wargs), fused_walk_flat_ref(*wargs))
    assert torch.equal(ops.dyn_node_walk_flat(*wargs), fused_walk_flat_ref(*wargs))
    assert torch.equal(ops.fused_leaf_flat(*largs), fused_leaf_flat_ref(*largs))
    assert {n: getattr(ops, n).launches for n in names} == before


@pytest.mark.parametrize("name", ["fused_walk_flat", "dyn_node_walk_flat", "fused_leaf_flat"])
def test_wrappers_off_cpu_raise_on_rows_out_of_range(name):
    """Off the CPU a wrapper checks the index's row count against the table
    (a host integer, no sync) before anything else; an index within range
    reaches the device check and is refused there (no kernel serves 'meta')."""
    if name == "fused_leaf_flat":
        args = list(_leaf_case(8, 5, 3, 33, 3, 3, 2))
    else:
        args = list(_walk_case("tree3", 5, 3, 33, 2, 3)[0])
    wrapper = getattr(ops, name)
    counter = getattr(ops, name.replace("_flat", ""))
    before = counter.launches
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*meta)
    meta[0] = args[0][: args[1].rows - 1].to("meta")  # one row short of the pack's reach
    with pytest.raises(ValueError, match="out of range"):
        wrapper(*meta)
    assert counter.launches == before


@pytest.mark.parametrize("npad,wc,stageable,staged", [
    (32, 20, True, True),      # RFS pack at the main shapes: 20 160 B
    (64, 20, True, True),      # 40 640 B
    (128, 20, True, True),     # 81 600 B
    (256, 20, True, False),    # the DRFS tree at hq 8: 163 520 B, over WALK_STAGE_MAX
    (512, 20, False, False),   # 327 040 B: over the shared memory of a block
    (24, 20, False, False),    # not a power of two
    (0, 20, False, False),
])
def test_walk_form_follows_the_staged_block_size(npad, wc, stageable, staged):
    """One rule for the staged edge block: its bytes decide the default form,
    the default falls back on a misaligned table, and a staged form forced on
    a table that cannot take it raises instead of running the other form."""
    assert ops.walk_stage_bytes(npad, wc) == (2 * npad - 1) * 2 * wc * 8
    assert ops.walk_stageable(npad, wc) is stageable
    assert ops.walk_staged(npad, wc) is staged
    assert ops.walk_form(npad, wc, 4096) is staged
    assert ops.walk_form(npad, wc, 4104) is False  # 8-byte aligned only
    assert ops.walk_form(npad, wc, 4104, staged=False) is False
    if stageable:
        assert ops.walk_form(npad, wc, 4096, staged=True) is True
    for ptr in ((4104,) if stageable else (4096, 4104)):
        with pytest.raises(ValueError, match="staged form"):
            ops.walk_form(npad, wc, ptr, staged=True)


def test_index_builders_raise_on_out_of_range_edges_or_bases():
    lvl_base = dyn_node_base(5, 3)
    good = walk_index(lvl_base, torch.tensor([0, 4, 2]), 8)
    assert good.rows == 2 * int((lvl_base + torch.tensor([8, 4, 2, 1])[:, None]).max())
    with pytest.raises(ValueError, match="out of range"):
        walk_index(lvl_base, torch.tensor([0, 5]), 8)
    with pytest.raises(ValueError, match="out of range"):
        walk_index(lvl_base, torch.tensor([-1, 2]), 8)
    with pytest.raises(ValueError, match="negative"):
        walk_index(lvl_base - 100, torch.tensor([0, 1]), 8)
    with pytest.raises(ValueError, match="lvl_base must be"):
        walk_index(lvl_base, torch.tensor([0]), 16)  # needs 5 levels, has 4
    assert leaf_index(torch.tensor([3, 1]), 4).rows == 4 * 10
    with pytest.raises(ValueError, match="out of range"):
        leaf_index(torch.tensor([-2, 1]), 4)


# ---------------------------------------------------------------- executors
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
