"""Fleet fault tolerance of the port's ``ReplicaRouter`` (the reference's
``test_serve_router_ft.py``, re-pointed at ``repro_torch``): any single
replica may be killed, query-faulted, stalled or ladder-diverged mid-stream
and (a) every admitted request resolves to exactly one Response, (b)
answers produced during failover equal a reference oracle — the reference
package's ``TNKDE(engine='numpy')`` fed the same mutations and pinned at
every admission — within ``TOL`` (1e-12 relative to max|F|), and (c) a
quarantined replica readmits through ``resync()`` with an identical epoch
ladder and no new CUDA library. Every replica runs on the same device (the
CPU here: ``device='cpu'``).
"""
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core.events import Events
from repro_torch.core.wal import WriteAheadLog
from repro_torch.ft.faults import (
    diverge_replica_mutation,
    fault_replica_queries,
    kill_replica,
    stall_replica,
)
from repro_torch.serve import (
    HEALTHY,
    QUARANTINED,
    SUSPECT,
    InsertItem,
    ProfileConfig,
    QueryItem,
    ReplicaRouter,
    run_server,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0)
TS = [2.5 * 86400.0, 6.0 * 86400.0]
DEPTH = 4
TOL = 1e-12
# (engine, executor, exact_leaf) of the replicas' profile
ENGINES = {"numpy": ("numpy", "auto", True), "packed": ("torch", "packed", False),
           "fused": ("torch", "fused", False)}


def _world(seed=7, n_events=240):
    net = port_spatial.make_network(24, 40, seed=seed)
    ev = port_spatial.make_events(net, n_events, seed=seed + 1, span_days=9)
    order = np.argsort(ev.time, kind="stable")
    return net, Events(ev.edge_id[order], ev.pos[order], ev.time[order])


def _sub(ev, lo, hi):
    return Events(ev.edge_id[lo:hi], ev.pos[lo:hi], ev.time[lo:hi])


def _profile(engine="numpy"):
    eng, ex, exact = ENGINES[engine]
    return ProfileConfig(solution="drfs", engine=eng, executor=ex, drfs_depth=DEPTH,
                         drfs_exact_leaf=exact, **KW)


def _router(net, base, engine="numpy", **kw):
    kw.setdefault("n_slots", 8)
    return ReplicaRouter(net, base, {"default": _profile(engine)}, device="cpu", **kw)


def _exact(got, ref, msg=""):
    assert float(np.abs(got - ref).max()) <= TOL * max(float(np.abs(ref).max()), 1e-300), msg


class _RefModel:
    """The reference's NumPy TNKDE behind the port's Events: ``insert``
    takes the port's batches."""

    def __init__(self, base, engine):
        net = ref_spatial.make_network(24, 40, seed=7)
        self.m = RefTNKDE(net, RefEvents(base.edge_id, base.pos, base.time), solution="drfs",
                          engine="numpy", drfs_depth=DEPTH, drfs_exact_leaf=ENGINES[engine][2],
                          **KW)

    def insert(self, ev):
        self.m.insert(RefEvents(ev.edge_id, ev.pos, ev.time))

    def snapshot(self):
        return self.m.snapshot()

    def query(self, ts, at=None):
        return self.m.query(ts, at=at)


class _Oracle:
    """A single reference model fed the same mutation stream; snapshots
    pinned at each router admission give the expected answer for every
    request, wherever the router ends up evaluating it."""

    def __init__(self, net, base, engine="numpy"):
        self.model = _RefModel(base, engine)
        self.pins = {}
        self.ts = {}

    def pin(self, tag, ts):
        self.pins[tag] = self.model.snapshot()
        self.ts[tag] = ts

    def check(self, r):
        assert r.ok, f"tag={r.tag}: {r.error}"
        _exact(r.heat, self.model.query(self.ts[r.tag], at=self.pins[r.tag]), f"tag={r.tag}")


# --------------------------------------------------- kill -> exact failover
@pytest.mark.parametrize("engine", list(ENGINES))
def test_kill_replica_failover_is_exact_and_loses_nothing(engine):
    """Kill one of three replicas with a third of the queue on it: every
    request still gets exactly one ok answer, the killed replica's share via
    pinned-epoch failover, all <=1e-12 vs the oracle."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(net, base, engine, replicas=3)
    oracle = _Oracle(net, base, engine)

    def submit(i):
        tag = f"q{i}"
        ts = [TS[0] + i * 1800.0]
        router.submit(ts, tag=tag)
        oracle.pin(tag, ts)

    for i in range(6):
        submit(i)
    router.insert(_sub(ev, 120, 160))
    oracle.model.insert(_sub(ev, 120, 160))
    for i in range(6, 12):
        submit(i)

    kill_replica(router.servers[1])
    rs = router.pump(force=True)
    assert sorted(r.tag for r in rs) == sorted(f"q{i}" for i in range(12))
    for r in rs:
        oracle.check(r)
    assert router.n_failovers >= 1
    assert router.health[1].state == QUARANTINED
    assert router.health[0].state == HEALTHY
    assert router.health[2].state == HEALTHY
    assert router.n_queued == 0
    agg = router.stats_json()
    assert agg["n_replica_unavailable"] == 0
    assert agg["n_failovers"] == router.n_failovers

    # the surviving pair keeps serving, and a mutation during quarantine
    # marks the dead replica resync-required (it missed stream state)
    router.insert(_sub(ev, 160, 180))
    oracle.model.insert(_sub(ev, 160, 180))
    submit(12)
    (r,) = router.pump(force=True)
    oracle.check(r)
    assert router.health[1].needs_resync


def test_query_fault_breaker_cooldown_half_open_probe_recovers():
    """A replica whose engine faults once: breaker trips (no resync needed —
    state is intact), cooldown ticks walk it to SUSPECT, a single probe
    request re-closes the breaker to HEALTHY."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(
        net, base, replicas=2,
        breaker_consec=2, cooldown_pumps=2, probe_oks=1,
    )
    oracle = _Oracle(net, base)
    fault_replica_queries(router.servers[1], fail_first=1)
    for i in range(4):  # round-robin puts two on the faulty replica
        tag = f"q{i}"
        ts = [TS[0] + i * 3600.0]
        router.submit(ts, tag=tag)
        oracle.pin(tag, ts)
    rs = router.pump(force=True)
    assert sorted(r.tag for r in rs) == [f"q{i}" for i in range(4)]
    for r in rs:
        oracle.check(r)
    assert router.health[1].state == QUARANTINED
    assert not router.health[1].needs_resync, "query faults leave state intact"
    assert router.n_failovers >= 1 and router.n_quarantines == 1

    router.pump(force=True)  # cooldown 2 -> 1
    router.pump(force=True)  # cooldown 1 -> 0: half-open
    assert router.health[1].state == SUSPECT

    k, _ = router.submit([TS[1]], tag="probe")
    assert k == 1, "half-open routing must steer the probe at the suspect"
    oracle.pin("probe", [TS[1]])
    (r,) = router.pump(force=True)
    oracle.check(r)
    assert router.health[1].state == HEALTHY


def test_stalled_replica_hedges_and_fast_copy_wins():
    """A straggling replica (flush EWMA blown past straggler_factor x the
    fleet minimum) gets hedged: the duplicate on the fast replica answers,
    the client sees exactly one Response per request, and it is exact."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(net, base, replicas=2, hedge_ms=2.0, straggler_factor=3.0)
    oracle = _Oracle(net, base)

    # prime both EWMAs with one warm flush each
    for i in range(2):
        router.submit([TS[0] + i * 3600.0], tag=f"prime{i}")
        oracle.pin(f"prime{i}", [TS[0] + i * 3600.0])
    router.pump(force=True)

    # pin the straggler signal deterministically (first-flush timings are
    # noisy: they carry one-time setup) and stall the slow replica for real
    # so the hedge must actually win the race
    stall_replica(router.servers[0], 0.08)
    router.servers[0].continuous.flush_ewma_s = 0.08
    router.servers[1].continuous.flush_ewma_s = 0.001

    victim = None
    extras = []
    for i in range(8):
        tag = f"v{i}"
        ts = [TS[1] - i * 1800.0]
        k, _ = router.submit(ts, tag=tag)
        oracle.pin(tag, ts)
        extras.append(tag)
        if k == 0:
            victim = tag
            break
    assert victim is not None, "round-robin must land a request on replica 0"
    import time as _t
    _t.sleep(0.01)  # age every entry past hedge_ms
    rs = router.pump(force=True)
    tags = [r.tag for r in rs]
    assert sorted(tags) == sorted(extras), "exactly one response per request"
    for r in rs:
        oracle.check(r)
    assert router.n_hedges >= 1
    assert router.n_hedge_wins >= 1
    assert router.n_queued == 0


# -------------------------------------------- mutation quorum + WAL resync
def test_divergent_mutation_quarantines_loser_and_resync_readmits(tmp_path):
    """A replica that silently walks a different epoch ladder on insert is
    quarantined needs_resync (not raised); resync() rebuilds it from the
    router WAL, re-verifies ladder + spot query, adds 0 jit entries, and
    the readmitted replica serves exact answers again."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(net, base, replicas=3)
    router.attach_wal(WriteAheadLog(str(tmp_path / "wal")))
    oracle = _Oracle(net, base)

    # batches sized UNDER the geometric auto-seal trigger (pending > 25% of
    # sealed): a fleet-wide auto-seal would mask the injected extra seal
    router.insert(_sub(ev, 120, 135))
    oracle.model.insert(_sub(ev, 120, 135))
    for i in range(3):
        tag = f"q{i}"
        ts = [TS[0] + i * 3600.0]
        router.submit(ts, tag=tag)
        oracle.pin(tag, ts)

    diverge_replica_mutation(router.servers[2])
    router.insert(_sub(ev, 135, 145))  # must NOT raise
    oracle.model.insert(_sub(ev, 135, 145))
    h = router.health[2]
    assert h.state == QUARANTINED and h.needs_resync
    assert router.health[0].state == HEALTHY
    assert router.health[1].state == HEALTHY

    rs = router.pump(force=True)
    assert sorted(r.tag for r in rs) == [f"q{i}" for i in range(3)]
    for r in rs:
        oracle.check(r)

    rep = router.resync(2)
    assert router.health[2].state == HEALTHY and not router.health[2].needs_resync
    assert rep["epoch_ok"] and rep["spot_max_abs_err"] <= 1e-12
    assert rep["jit_entries_added"] == 0, "resync must load no library"
    ladders = {
        tuple(s.models["default"].epoch for s in router.servers[k:k + 1])
        for k in range(3)
    }
    assert len(ladders) == 1, "readmitted replica must match the fleet ladder"
    assert router.n_resyncs == 1

    # the resynced replica carries real traffic again, exactly
    for i in range(3, 9):
        tag = f"q{i}"
        ts = [TS[1] - i * 1800.0]
        router.submit(ts, tag=tag)
        oracle.pin(tag, ts)
    rs = router.pump(force=True)
    assert len(rs) == 6
    for r in rs:
        oracle.check(r)


def test_mutation_minority_failure_quarantines_uniform_failure_raises(tmp_path):
    """Quorum semantics: an insert that fails on ONE replica quarantines it
    (needs_resync) and the fleet proceeds; an insert that is invalid
    everywhere raises AND never reaches the WAL (validate-before-log)."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    wal = WriteAheadLog(str(tmp_path / "wal"))
    router = _router(net, base, replicas=3)
    router.attach_wal(wal)
    router.insert(_sub(ev, 120, 140))

    def boom(events):
        raise RuntimeError("disk full")

    router.servers[0].insert = boom
    router.insert(_sub(ev, 140, 160))  # minority failure: no raise
    assert router.health[0].state == QUARANTINED
    assert router.health[0].needs_resync
    assert router.health[1].state == HEALTHY
    seq_before = wal.last_seq

    bad = Events(
        np.array([net.n_edges + 7], dtype=np.int64),
        np.array([0.5]), np.array([1.0]),
    )
    with pytest.raises(Exception):
        router.insert(bad)
    assert wal.last_seq == seq_before, "invalid batch must not poison the WAL"
    assert router.health[1].state == HEALTHY
    assert router.health[2].state == HEALTHY


def test_checkpoint_then_wal_suffix_resync(tmp_path):
    """resync() restores the latest fleet checkpoint and replays only the
    WAL suffix past it: restored_step == the checkpoint's sequence number
    and the ladder matches the healthy reference."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(net, base, "fused", replicas=2)
    router.attach_wal(WriteAheadLog(str(tmp_path / "wal")))
    router.insert(_sub(ev, 120, 150))
    seq = router.checkpoint(str(tmp_path / "ckpt"))
    router.insert(_sub(ev, 150, 185))  # the suffix

    router.health[1].trip(needs_resync=True)  # forced quarantine
    rep = router.resync(1)
    assert rep["restored_step"] == seq
    assert rep["epoch_ok"]
    assert (
        router.servers[1].models["default"].epoch
        == router.servers[0].models["default"].epoch
    )

    oracle = _Oracle(net, base, "fused")
    oracle.model.insert(_sub(ev, 120, 150))
    oracle.model.insert(_sub(ev, 150, 185))
    for i in range(4):
        tag = f"q{i}"
        ts = [TS[0] + i * 3600.0]
        router.submit(ts, tag=tag)
        oracle.pin(tag, ts)
    rs = router.pump(force=True)
    assert len(rs) == 4
    for r in rs:
        oracle.check(r)


def test_resync_without_wal_refuses():
    net, ev = _world()
    router = _router(net, _sub(ev, 0, 120), replicas=2)
    router.health[1].trip(needs_resync=True)
    with pytest.raises(RuntimeError, match="WAL"):
        router.resync(1)
    assert router.health[1].state == QUARANTINED


# ------------------------------------------------ loadgen accounting + kill
def test_loadgen_accounting_invariant_under_mid_run_kill():
    """run_server through a kill: every QueryItem is a latency sample, an
    error, or a shed — failover neither loses nor duplicates answers — and
    the LoadReport surfaces the failover counters."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    router = _router(net, base, replicas=3)
    workload = []
    for i in range(9):
        workload.append(QueryItem(ts=[TS[0] + i * 1800.0]))
    workload.append(InsertItem(events=_sub(ev, 120, 150)))
    for i in range(9, 18):
        workload.append(QueryItem(ts=[TS[1] - i * 1800.0]))

    orig_pump = router.pump
    calls = {"n": 0}

    def pump(**kw):
        calls["n"] += 1
        if calls["n"] == 1:
            kill_replica(router.servers[2])
        return orig_pump(**kw)

    router.pump = pump
    rep = run_server(router, workload, rate_hz=None)
    nq = sum(1 for it in workload if isinstance(it, QueryItem))
    assert len(rep.latencies) + rep.n_errors + rep.n_shed == nq
    assert rep.n_failovers == router.n_failovers > 0
    assert rep.n_errors == 0, "killed replica's share must fail over, not error"
    assert router.health[2].state == QUARANTINED
    assert rep.summary()["n_failovers"] == router.n_failovers


# --------------------------------------------------------------- satellites
def test_pick_counts_inflight_slots_not_just_queued():
    """Routing load must include slots a flush already claimed: with equal
    queue depths but one replica holding an in-flight slot, new admissions
    go to the idle replica."""
    net, ev = _world()
    router = _router(net, _sub(ev, 0, 120), replicas=2)
    r0, r1 = router.servers
    router.submit([TS[0]], tag="a")
    router.submit([TS[0] + 3600.0], tag="b")  # round-robin: one each
    assert r0.n_queued == r1.n_queued == 1
    slot = next(s for s in r0.continuous.scheduler.slots if s.req is not None)
    slot.inflight = True
    assert r0.load == r1.load + 1
    k, _ = router.submit([TS[1]], tag="c")
    assert k == 1, "in-flight occupancy must steer admission away"
    slot.inflight = False
    rs = router.pump(force=True)
    assert sorted(r.tag for r in rs) == ["a", "b", "c"]


def test_fleet_warmup_reports_per_replica_and_zero_growth_after_first():
    net, ev = _world()
    router = _router(net, _sub(ev, 0, 120), replicas=3)
    w = router.warmup()
    assert len(w["replicas"]) == 3
    assert len(w["per_replica_jit_entries"]) == 3
    assert w["jit_entries_added_after_first"] == 0
    assert w["jit_entries_before"] == w["per_replica_jit_entries"][0][0]
    assert w["jit_entries_after"] == w["per_replica_jit_entries"][-1][1]


def test_server_cancel_continuous_and_microbatch():
    """The cancellation hook failover/hedging rides on: waiting requests are
    removable by id or tag in both cores; in-flight slots are not."""
    net, ev = _world()
    base = _sub(ev, 0, 120)
    from repro_torch.serve import TNKDEServer

    srv = TNKDEServer(net, base, {"default": _profile()},
                      mode="continuous", n_slots=4, device="cpu")
    srv.submit(TS, tag="keep")
    srv.submit(TS, tag="drop")
    assert srv.cancel(tag="drop") == 1
    assert srv.cancel(request_id=10 ** 9) == 0
    assert srv.stats.n_cancelled == 1
    rs = srv.pump(force=True)
    assert [r.tag for r in rs] == ["keep"]

    srv2 = TNKDEServer(net, base, {"default": _profile()}, mode="microbatch", device="cpu")
    rid = srv2.submit(TS, tag="x")
    srv2.submit(TS, tag="y")
    assert srv2.cancel(request_id=rid) == 1
    rs = srv2.pump(force=True)
    assert [r.tag for r in rs] == ["y"]
