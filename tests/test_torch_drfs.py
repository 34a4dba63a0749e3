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

The equivalence matrix lives in ``tests/test_torch_drfs_matrix_<executor>.py``
and the streaming scripts in ``tests/test_torch_drfs_streaming.py`` (one
file each keeps the tier-1 run's files short); the shared worlds and helpers
are in ``tests/torch_drfs_common.py``.
"""
import numpy as np
import pytest

from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import EdgeEvents, Events
from torch_drfs_common import KW, N_BASE, N_INS, TS5, _rel, _sps_over, _sub
from torch_drfs_common import worlds, x64_shim  # noqa: F401 (fixtures)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


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
