"""The kernel executor's quantized DRFS tree phase on the flat leaf table in
place, on the CPU.

``ops.dyn_leaf_query_flat`` computes the reference's ``dyn_leaf_query`` with
its query vectors ``qv_l/qv_r = q_s ⊗ qtl / q_s ⊗ qtr`` (s-major) built in
the kernel (``csrc/fused_leaf.cu`` on the card; here its plain version,
``fused_leaf_flat_ref``), reading a flat ``[E·(nleaf+1)·2, W·2K]`` table
through a ``FlatIndex``. It must be

* within 1e-13 of max|want| of ``repro.kernels.ref.dyn_leaf_query`` and the
  Pallas kernel in interpret mode, fed the grouped copy of the table and
  ``qv`` built in numpy from the same seeded inputs (float64; an output
  sums 2·K products, K up to 121, and the two sides associate the sums
  differently: the reference with an einsum, the port in k order);
* equal to ``fused_leaf_flat`` bitwise (one function, one association) and
  counted in ``dyn_leaf_query.launches`` only where a kernel launches.

``TNKDE(solution='drfs', executor='kernel')`` in quantized mode then answers
bitwise as ``executor='fused'`` and within 1e-12 of the reference's
``engine='numpy'``, before and after an insert; no executor keeps a grouped
copy of any window table.
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
from repro.kernels import ref as ref_oracle
from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.core.rfs import dyn_kernel_call
from repro_torch.kernels import ops
from repro_torch.kernels.fused_walk import fused_leaf_flat_ref, leaf_index

# (nleaf, E, G, Q, W, k_s, k_t): the reference's sweep, ragged Q above a
# block, W > 8 windows, and K = k_s·k_t = 121 of the gaussian kernels
CASES = [
    (4, 5, 3, 7, 1, 2, 1), (8, 5, 3, 33, 3, 2, 2), (16, 6, 3, 65, 2, 3, 1),
    (32, 5, 4, 130, 9, 2, 2), (8, 4, 3, 17, 2, 11, 11),
]
TOL = 1e-13


def _case(nleaf, E, G, Q, W, ks, kt):
    """A flat leaf-prefix table of E edges (dyn_window_tables' layout), G
    groups on edges drawn with repeats, every fifth slot an empty range."""
    rng = np.random.default_rng(nleaf * 1000 + E * 10 + Q + ks * kt)
    R = (nleaf + 1) * 2
    lcum = np.cumsum(rng.normal(size=(E, R, W * 2 * ks * kt)), axis=1).reshape(E * R, -1)
    edges = rng.integers(0, E, G)
    lo = rng.integers(0, nleaf + 1, (G, Q))
    hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), lo)
    hi[:, ::5] = lo[:, ::5]
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    qtl, qtr = rng.normal(size=(W, kt)), rng.normal(size=(W, kt))
    return lcum, edges, lo, hi, side, qs, qtl, qtr


def _torch(nleaf, arrs):
    lcum, edges, lo, hi, side, qs, qtl, qtr = arrs
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    f64 = torch.as_tensor
    return (f64(lcum), leaf_index(torch.as_tensor(edges), nleaf), i32(lo), i32(hi), i32(side),
            f64(qs), f64(qtl), f64(qtr))


def _reference_args(nleaf, arrs):
    """The reference's contract, built in numpy: the grouped copy
    [G, R, W·2K] and qv_l/qv_r [G, W, Q, K] = q_s ⊗ q_t, s-major."""
    lcum, edges, lo, hi, side, qs, qtl, qtr = arrs
    R = (nleaf + 1) * 2
    tab = lcum.reshape(-1, R, lcum.shape[1])[edges]
    G, Q, ks = qs.shape
    W, kt = qtl.shape

    def qv(qt):
        return (qs[:, None, :, :, None] * qt[None, :, None, None, :]).reshape(G, W, Q, ks * kt)

    return tab, lo, hi, side, qv(qtl), qv(qtr)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("nleaf,E,G,Q,W,ks,kt", CASES)
def test_flat_leaf_query_matches_reference(nleaf, E, G, Q, W, ks, kt, oracle):
    from repro.kernels.dyn_query import dyn_leaf_query_pallas

    arrs = _case(nleaf, E, G, Q, W, ks, kt)
    before = ops.dyn_leaf_query.launches
    got = ops.dyn_leaf_query_flat(*_torch(nleaf, arrs)).numpy()
    assert ops.dyn_leaf_query.launches == before  # the CPU runs the plain version
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in _reference_args(nleaf, arrs)]
        if oracle == "ref":
            want = np.asarray(ref_oracle.dyn_leaf_query(*jargs))
        else:
            want = np.asarray(dyn_leaf_query_pallas(*jargs, tq=32, interpret=True))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert want.shape == (G, W, Q) and got.shape == (G, Q, W)
    want = want.transpose(0, 2, 1)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= TOL * scale
    assert (got[:, ::5] == 0.0).all()  # empty ranges are exact zeros


@pytest.mark.parametrize("nleaf,E,G,Q,W,ks,kt", CASES)
def test_flat_leaf_query_is_the_fused_leaf_function(nleaf, E, G, Q, W, ks, kt):
    """One function, one association: bitwise the fused executor's call."""
    args = _torch(nleaf, _case(nleaf, E, G, Q, W, ks, kt))
    names = ("dyn_leaf_query", "fused_leaf")
    before = {n: getattr(ops, n).launches for n in names}
    got = ops.dyn_leaf_query_flat(*args)
    assert torch.equal(got, ops.fused_leaf_flat(*args))
    assert torch.equal(got, fused_leaf_flat_ref(*args))
    assert {n: getattr(ops, n).launches for n in names} == before


def test_flat_leaf_query_off_cpu_raises():
    """Off the CPU the wrapper launches its kernel or raises: rows beyond the
    table first (no sync), then a device no kernel serves."""
    args = list(_torch(8, _case(8, 5, 3, 33, 3, 2, 2)))
    before = (ops.dyn_leaf_query.launches, ops.fused_leaf.launches)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="dyn_leaf_query: unsupported device"):
        ops.dyn_leaf_query_flat(*meta)
    meta[0] = args[0][: args[1].rows - 1].to("meta")
    with pytest.raises(ValueError, match="out of range"):
        ops.dyn_leaf_query_flat(*meta)
    assert (ops.dyn_leaf_query.launches, ops.fused_leaf.launches) == before


# ---------------------------------------------------------------- executors
KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0, drfs_depth=5)
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
def test_kernel_executor_quantized_matches_fused_and_reference(worlds, ks, kt, monkeypatch):
    (net, ev), (rnet, rev) = worlds
    kw = dict(solution="drfs", drfs_exact_leaf=False, spatial_kernel=ks, temporal_kernel=kt,
              **KW)
    ref = RefTNKDE(rnet, RefEvents(*(a[:N_BASE] for a in rev)), engine="numpy", **kw)
    models = {ex: TNKDE(net, Events(*(a[:N_BASE] for a in ev)), engine="torch", executor=ex,
                        device="cpu", **kw) for ex in ("fused", "kernel")}
    calls = []
    flat = ops.dyn_leaf_query_flat

    def grouped(*a, **k):
        raise AssertionError("the flush called the grouped contract")

    monkeypatch.setattr(ops, "dyn_leaf_query_flat", lambda *a: calls.append(1) or flat(*a))
    monkeypatch.setattr(ops, "dyn_leaf_query", grouped)
    for step in ("base", "insert"):
        if step == "insert":
            ref.insert(RefEvents(*(a[N_BASE:N_BASE + N_INS] for a in rev)))
            for m in models.values():
                m.insert(Events(*(a[N_BASE:N_BASE + N_INS] for a in ev)))
        want = ref.query(TS5)
        km = models["kernel"]
        n0 = len(calls)
        got = {ex: m.query(TS5) for ex, m in models.items()}
        F = got["kernel"]
        assert len(calls) - n0 == km._host_plan(km.snapshot()).n_blocks  # one call a block
        assert np.abs(want).max() > 0
        assert np.array_equal(F, got["fused"]), step
        assert _rel(F, want) <= 1e-12, step
        assert np.array_equal(F[1], F[4])
        assert np.array_equal(km.query(TS5), F)  # warm == cold


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
def test_no_executor_keeps_a_grouped_copy(worlds, executor):
    """Every executor reads the cached window tables as they are: no grouped
    cache exists, the kernel executors' tables are views of the cached ones
    in both modes, and the device bytes are the fused executor's."""
    (net, ev), _ = worlds
    kw = dict(solution="drfs", engine="torch", device="cpu", **KW)
    m = TNKDE(net, Events(*(a[:N_BASE] for a in ev)), executor=executor, **kw)
    fused = TNKDE(net, Events(*(a[:N_BASE] for a in ev)), executor="fused", **kw)
    for exact in (False, True):
        m.drfs_exact_leaf = fused.drfs_exact_leaf = exact
        m.query(TS5)
        fused.query(TS5)
    fe = m._fe
    assert not hasattr(fe, "_group_cache")
    if executor == "packed":  # no kernel layout at all
        return
    assert fe.device_bytes == fused._fe.device_bytes
    snap = m.snapshot()
    wb = fe.window_batch(m.ctx, TS5)
    forest = fe._forest(fe._get_sealed(snap), fe._get_pending(snap))
    for exact in (False, True):
        (tables,) = [t for k, t in fe._tab_cache.items() if k[4] == exact]
        for entry in fe._atom_packs(m._host_plan(snap)):
            tab, index = fe.tree_table(tables, entry, hq=snap.depth, exact=exact)
            assert tab.dim() == 2 and tab.data_ptr() == tables[0].data_ptr()
            name, args, _ = dyn_kernel_call(forest, tab, entry, wb, hq=snap.depth, exact=exact,
                                            executor=executor, index=index)
            assert args[0] is tab and args[1] is index
            assert not any(isinstance(a, torch.Tensor) and a.dim() == 4 for a in args)  # no qv
            assert name.endswith("_flat")
