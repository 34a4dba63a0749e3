"""The DRFS slice on the CPU: the port's streaming index and
``TNKDE(solution='drfs', engine='torch', device='cpu')`` against the JAX
package.

* ``core/drfs.py`` is NumPy in both packages: after build, inserts, seals,
  extends and evictions the two ``state_tree()`` captures must be bitwise
  equal at equal epochs;
* the device engine (each kernel's plain version on the CPU) stays ≤ 1e-12
  relative to max|F| from the reference's ``engine='numpy'`` (float64 both
  sides, same tables; only summation order differs), with pending events
  live;
* streaming interleavings are held against the reference NumPy DRFS
  (≤ 1e-12) and, in exact mode, against the port's index-free SPS oracle
  over the current event set (≤ 1e-9: a different algorithm);
* work counters equal the reference's ``jax/packed``, ``jax/fused`` and,
  for ``executor='kernel'``, its ``executor='pallas'`` tier.
"""
import jax
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import EdgeEvents, Events

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
# one duplicated centre; the 11-day window covers the inserted (latest) events
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 11 * 86400.0, 4 * 86400.0]
FAMILIES = [("triangular", "quartic"), ("epanechnikov", "cosine"), ("gaussian", "triangular")]
N_BASE, N_INS = 700, 100  # the insert stays pending (100 < 700 / 4 seal trigger)


def _sorted_world(mod, n_nodes=60, n_edges=100, seed=13, n_events=800, span_days=12):
    net = mod.make_network(n_nodes, n_edges, seed=seed)
    ev = mod.make_events(net, n_events, seed=seed + 1, span_days=span_days)
    o = np.argsort(ev.time, kind="stable")
    return net, (ev.edge_id[o], ev.pos[o], ev.time[o])


@pytest.fixture(scope="module")
def worlds():
    return _sorted_world(port_spatial), _sorted_world(ref_spatial)


def _sub(cls, arrs, lo, hi):
    return cls(*(a[lo:hi] for a in arrs))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference's device engines call ``jax.experimental.enable_x64``,
    which newer jax releases dropped; restored for one test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda *a, **k: jax.enable_x64(True), raising=False)


# --------------------------------------------------- the index, bitwise
def _state(df):
    return {k: np.asarray(v) for k, v in df.state_tree().items()}


def _assert_same_forest(port, ref):
    assert port.epoch == ref.epoch and port.depth == ref.depth
    a, b = _state(port), _state(ref)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("script", [
    ("build",),
    ("insert", "seal"),
    ("insert", "insert", "seal", "extend"),
    ("extend", "insert", "seal", "evict"),
    ("insert", "evict", "seal", "insert", "seal"),
])
def test_dynamic_range_forest_equals_reference(worlds, script):
    (net, ev), (rnet, rev) = worlds
    port_m = TNKDE(net, _sub(Events, ev, 0, 400), solution="drfs", engine="numpy",
                   drfs_depth=4, auto_seal=False, **KW)
    ref_m = RefTNKDE(rnet, _sub(RefEvents, rev, 0, 400), solution="drfs", engine="numpy",
                     drfs_depth=4, auto_seal=False, **KW)
    pf, rf = port_m.index, ref_m.index
    n = 400
    for op in script:
        if op == "insert":
            port_m.insert(_sub(Events, ev, n, n + 150))
            ref_m.insert(_sub(RefEvents, rev, n, n + 150))
            n += 150
        elif op == "seal":
            pf.seal()
            rf.seal()
        elif op == "extend":
            pf.extend()
            rf.extend()
        elif op == "evict":
            cutoff = float(np.median(ev[2][:n]))
            a, b = pf.evict_before(cutoff), rf.evict_before(cutoff)
            assert np.array_equal(a, b) and a.sum() > 0
    pf.seal()
    rf.seal()
    _assert_same_forest(pf, rf)
    assert pf.index_bytes == rf.index_bytes


def test_load_state_serves_reference_state(worlds):
    """The carry-across function: the reference's state_tree() (after an
    insert and a seal) loaded into the port's forest — the rebinding a
    restore does — answers ≤ 1e-12 from the reference at the same epoch."""
    (net, ev), (rnet, rev) = worlds
    mk = dict(solution="drfs", drfs_depth=5, drfs_exact_leaf=True, **KW)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, N_BASE), engine="numpy", **mk)
    ref.insert(_sub(RefEvents, rev, N_BASE, 800))
    ref.seal()
    rf = ref.index
    port = TNKDE(net, _sub(Events, ev, 0, N_BASE), engine="torch", executor="fused",
                 device="cpu", **mk)  # same base events: same moment context
    port.index.load_state(rf.state_tree(), depth=rf.depth, revision=rf.revision,
                          pend_revision=rf.pend_revision)
    _assert_same_forest(port.index, rf)
    df = port.index
    port.ee = EdgeEvents(ptr=df.ptr, pos=df.pos, time=df.time,
                         t_min=float(df.time.min()), t_max=float(df.time.max()))
    port._build_engine()  # fresh device packs over the loaded state
    assert port.epoch == ref.epoch
    assert _rel(port.query(TS5), ref.query(TS5)) <= 1e-12


# ------------------------------------------------- equivalence matrix
_REF = {}


def _reference(worlds, ks, kt, exact, ls):
    key = (ks, kt, exact, ls)
    if key not in _REF:
        _, (rnet, rev) = worlds
        m = RefTNKDE(rnet, _sub(RefEvents, rev, 0, N_BASE), solution="drfs", engine="numpy",
                     drfs_depth=5, drfs_exact_leaf=exact, lixel_sharing=ls,
                     spatial_kernel=ks, temporal_kernel=kt, **KW)
        m.insert(_sub(RefEvents, rev, N_BASE, N_BASE + N_INS))
        _REF[key] = m.query(TS5)
    return _REF[key]


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("ls", [False, True])
@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("ks,kt", FAMILIES)
def test_drfs_torch_engine_matches_reference(worlds, ks, kt, W, ls, exact, executor):
    (net, ev), _ = worlds
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), solution="drfs", engine="torch",
              executor=executor, device="cpu", drfs_depth=5, drfs_exact_leaf=exact,
              lixel_sharing=ls, spatial_kernel=ks, temporal_kernel=kt, **KW)
    assert m.engine_desc == f"torch/{executor}"
    m.insert(_sub(Events, ev, N_BASE, N_BASE + N_INS))
    assert m.index.n_pending == N_INS
    got = m.query(TS5[:W])
    want = _reference(worlds, ks, kt, exact, ls)[:W]
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-12
    if W == 5:
        assert np.array_equal(got[1], got[4])  # duplicate centres, pending scans live


# ----------------------------------------------------- streaming scripts
SKW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0)
STS = [2.5 * 86400.0, 6.0 * 86400.0]


def _small_worlds(seed):
    args = dict(n_nodes=24, n_edges=40, seed=seed, n_events=240, span_days=9)
    return _sorted_world(port_spatial, **args), _sorted_world(ref_spatial, **args)


def _sps_over(net, m, ts, kw=SKW):
    """The port's index-free oracle over the model's CURRENT event set."""
    e, p, t = m.index.snapshot().event_set()
    return TNKDE(net, Events(e, p, t), solution="sps", **kw).query(ts)


def _script(rng, n_ops):
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        ops.append(("insert", int(rng.integers(1, 45))) if r < 0.45 else
                   ("seal",) if r < 0.6 else ("extend",) if r < 0.7 else ("query",))
    return ops


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_interleavings_match_reference_and_sps(seed, executor):
    (net, ev), (rnet, rev) = _small_worlds(7 + seed)
    mk = dict(solution="drfs", drfs_depth=4, drfs_exact_leaf=True, **SKW)
    m = TNKDE(net, _sub(Events, ev, 0, 40), engine="torch", executor=executor, device="cpu", **mk)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, 40), engine="numpy", **mk)
    n, n_ext = 40, 0
    for op in _script(np.random.default_rng(seed * 101 + 5), 9) + [("query",)]:
        if op[0] == "insert":
            k = min(op[1], len(ev[0]) - n)
            m.insert(_sub(Events, ev, n, n + k))
            ref.insert(_sub(RefEvents, rev, n, n + k))
            n += k
        elif op[0] == "seal":
            m.seal()
            ref.seal()
        elif op[0] == "extend" and n_ext < 2:  # bound the depth drift
            m.extend()
            ref.extend()
            n_ext += 1
        elif op[0] == "query":
            got, want = m.query(STS), ref.query(STS)
            assert m.epoch == ref.epoch
            assert _rel(got, want) <= 1e-12
            sps = _sps_over(net, m, STS)
            np.testing.assert_allclose(got, sps, rtol=1e-9, atol=1e-9 * max(sps.max(), 1.0))


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_under_horizon_matches_reference_and_sps(seed, executor):
    """Bulk inserts + compact() under a sliding horizon: after every
    compaction the port equals the reference and a fresh SPS over exactly
    the surviving events; compact() reports what the reference reports."""
    (net, ev), (rnet, rev) = _small_worlds(11 + seed)
    rng = np.random.default_rng(seed * 31 + 7)
    mk = dict(solution="drfs", drfs_depth=4, drfs_exact_leaf=True, auto_seal=False,
              horizon_s=2.5 * 86400.0, **SKW)
    m = TNKDE(net, _sub(Events, ev, 0, 40), engine="torch", executor=executor, device="cpu", **mk)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, 40), engine="numpy", **mk)
    n, evicted = 40, 0
    while n < len(ev[0]):
        k = min(int(rng.integers(15, 60)), len(ev[0]) - n)
        m.insert(_sub(Events, ev, n, n + k))
        ref.insert(_sub(RefEvents, rev, n, n + k))
        n += k
        assert m.needs_compaction == ref.needs_compaction
        out = m.compact()
        assert out == ref.compact() and m.index.n_pending == 0
        evicted += out["evicted"]
        if out["evicted"]:  # the device packs of pre-eviction epochs are gone
            assert all(key[0] >= m.epoch[0] for key in m._fe._sealed_packs)
        assert m.epoch == ref.epoch and m.stream_t_max == ref.stream_t_max
        assert np.array_equal(m.ev_min_pos, ref.ev_min_pos)
        assert np.array_equal(np.diff(m.ee.ptr), np.diff(ref.ee.ptr))
        qts = [m.stream_t_max - 0.5 * 86400.0, m.stream_t_max]
        got, want = m.query(qts), ref.query(qts)
        assert _rel(got, want) <= 1e-12
        sps = _sps_over(net, m, qts)
        np.testing.assert_allclose(got, sps, rtol=1e-9, atol=1e-9 * max(sps.max(), 1.0))
    assert evicted > 0


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
def test_pinned_snapshot_answers_its_epoch(worlds, executor):
    """MVCC: a snapshot pinned before an insert, a seal and an extend answers
    bitwise like the query taken at pin time; the live head moves on."""
    (net, ev), _ = worlds
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), solution="drfs", engine="torch",
              executor=executor, device="cpu", drfs_depth=4, drfs_exact_leaf=True, **KW)
    before = m.query(TS5)
    snap = m.snapshot()
    m.insert(_sub(Events, ev, N_BASE, 800))
    live_pending = m.query(TS5)
    m.seal()
    m.extend()
    assert snap.epoch != m.epoch and snap.n_pending == 0
    assert np.array_equal(m.query(TS5, at=snap), before)
    assert not np.array_equal(live_pending, before)
    sps = _sps_over(net, m, TS5, KW)
    np.testing.assert_allclose(m.query(TS5), sps, rtol=1e-9, atol=1e-9 * sps.max())


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
def test_warm_query_and_launch_accounting(worlds, executor):
    """Warm == cold bitwise; a warm query searches nothing; the fused engine
    counts one launch per atom block per flush, in both modes (the kernel
    executor, as the reference's pallas tier, counts none there)."""
    (net, ev), _ = worlds
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), solution="drfs", engine="torch",
              executor=executor, device="cpu", drfs_depth=5, **KW)
    m.insert(_sub(Events, ev, N_BASE, N_BASE + N_INS))
    for exact in (False, True):
        m.drfs_exact_leaf = exact
        blocks = m._host_plan(m.snapshot()).n_blocks
        l0 = m._fe.counters["fused_launches"]
        cold = m.query(TS5)
        s0 = m.stats.n_rank_searches
        assert np.array_equal(m.query(TS5), cold)
        assert m.stats.n_rank_searches == s0
        launched = m._fe.counters["fused_launches"] - l0
        assert launched == (2 * blocks if executor == "fused" else 0)
    assert m.stats.bytes_per_shard == m._fe.device_bytes > 0


# -------------------------------------------------------------- counters
# the reference's name of each executor and the engine_desc it reports
REF_EXECUTOR = {"packed": ("packed", "jax/packed"), "fused": ("fused", "jax/fused"),
                "kernel": ("pallas", "pallas/pallas")}


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
def test_counters_equal_reference_device_engine(worlds, x64_shim, executor):
    """n_rank_searches / n_moment_gathers / bytes_moved / n_pending_scanned /
    n_partial_scanned (and the launch count) follow the reference's
    formulas: equal to its jax engine (for ``kernel``, its
    ``executor='pallas'`` tier), both modes, cold and warm, with pending
    events live and after a seal."""
    (net, ev), (rnet, rev) = worlds
    ref_executor, ref_desc = REF_EXECUTOR[executor]
    mk = dict(solution="drfs", drfs_depth=5, **KW)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, N_BASE), engine="jax", executor=ref_executor,
                   **mk)
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), engine="torch", device="cpu", executor=executor,
              **mk)
    assert ref.engine_desc == ref_desc and m.engine_desc == f"torch/{executor}"
    ts = TS5[:3]
    for step in ("insert", "query", "seal", "query"):
        if step == "insert":
            ref.insert(_sub(RefEvents, rev, N_BASE, N_BASE + N_INS))
            m.insert(_sub(Events, ev, N_BASE, N_BASE + N_INS))
            continue
        if step == "seal":
            ref.seal()
            m.seal()
            continue
        for exact in (False, True, False):  # the last one is warm
            ref.drfs_exact_leaf = m.drfs_exact_leaf = exact
            F_ref, F = ref.query(ts), m.query(ts)
            assert _rel(F, F_ref) <= 1e-12
            for stat in ("n_atoms", "n_rank_searches", "n_moment_gathers", "bytes_moved",
                         "n_pending_scanned", "n_partial_scanned"):
                assert getattr(m.stats, stat) == getattr(ref.stats, stat), stat
            assert m._fe.counters["fused_launches"] == ref._fe.counters["fused_launches"]
    assert m.stats.n_pending_scanned > 0 and m.stats.n_partial_scanned > 0
    assert (m._fe.counters["fused_launches"] > 0) == (executor == "fused")


def test_consume_counters_survives_a_counter_that_shrank(worlds):
    """An engine swapped in restarts its counters at 0: the cursor resets
    with it instead of subtracting (the reference's rule)."""
    (net, ev), _ = worlds
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), solution="drfs", engine="torch",
              executor="packed", device="cpu", drfs_depth=4, **KW)
    m.query(TS5)
    g0 = m.stats.n_moment_gathers
    from repro_torch.core.rfs import FlatDynamicEngine

    m._fe = FlatDynamicEngine(m.index, executor="packed", device="cpu")
    m.query(TS5[:1])  # less work than the old engine's running total
    g1 = m._fe.counters["moment_gathers"]
    assert 0 < g1 < g0
    assert m.stats.n_moment_gathers == g0 + g1  # counted from 0, never negative


# ------------------------------------------------------ front-end rules
def test_streaming_front_end_rules(worlds):
    (net, ev), _ = worlds
    rfs = TNKDE(net, _sub(Events, ev, 0, 100), solution="rfs", engine="numpy", **KW)
    for name in ("insert", "seal", "extend", "compact"):
        with pytest.raises(ValueError, match="requires solution='drfs'"):
            getattr(rfs, name)(*((_sub(Events, ev, 100, 110),) if name == "insert" else ()))
    assert rfs.snapshot() is None and not rfs.needs_compaction
    with pytest.raises(ValueError, match="requires solution='drfs'"):
        rfs.query(TS5[:1], at=object())
    for kwargs in (dict(horizon_s=3600.0), dict(auto_seal=False),
                   dict(solution="drfs", executor="search"),
                   dict(solution="drfs", horizon_s=-1.0)):
        with pytest.raises(ValueError):
            TNKDE(net, _sub(Events, ev, 0, 100), device="cpu", **{**KW, **kwargs})
    m = TNKDE(net, _sub(Events, ev, 0, 100), solution="drfs", engine="numpy", drfs_depth=3, **KW)
    assert m.engine_desc == "numpy"
    bad = Events(np.array([net.n_edges]), np.array([0.0]), np.array([1.0]))
    with pytest.raises(ValueError):  # EventValidationError, before any mutation
        m.insert(bad)
    assert m.epoch == (3, 0) and m.index.n_pending == 0
    auto = TNKDE(net, _sub(Events, ev, 0, 100), solution="drfs", device="cpu", drfs_depth=3, **KW)
    assert auto.engine_desc == "torch/packed"
