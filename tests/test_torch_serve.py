"""The port's serve tier (``repro_torch.serve``) against the reference
package: the pinned-oracle tests of ``test_serve.py`` and
``test_serve_continuous.py``, re-pointed at the port.

The oracle is the reference's ``TNKDE(engine='numpy')`` fed the same
mutation stream, pinned (``snapshot()``) at every admission: each served
answer must equal it at the request's pinned epoch within ``TOL`` (1e-12
relative to max|F|: float64 both sides, only summation order differs), on
the port's host engine and its device executors (``torch/packed``,
``torch/fused``) run on the CPU (``device='cpu'``: the kernels' plain
versions), in both micro-batch and continuous mode, quantized and
exact-leaf. Plus batching, the result cache, lixel slicing, the compile
audit's keys, the load drivers, ``make_request_mix`` equal to the
reference's, and ``serve_tnkde`` through the launcher, with and without
durability.
"""
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro.serve as ref_serve
import repro_torch.data.spatial as port_spatial
import repro_torch.launch.serve as launch
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.serve import (
    InsertItem,
    ProfileConfig,
    QueryItem,
    ReplicaRouter,
    TNKDEServer,
    jit_entries,
    make_request_mix,
    run_open_loop,
    run_sequential,
    run_server,
    window_class,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0)
TS = [2.5 * 86400.0, 6.0 * 86400.0]
DEPTH = 4
TOL = 1e-12
# (engine, executor) of the port's profile
ENGINES = {"numpy": ("numpy", "auto"), "packed": ("torch", "packed"), "fused": ("torch", "fused")}


def _world(seed=7, n_events=240):
    net = port_spatial.make_network(24, 40, seed=seed)
    ev = port_spatial.make_events(net, n_events, seed=seed + 1, span_days=9)
    order = np.argsort(ev.time, kind="stable")
    return net, Events(ev.edge_id[order], ev.pos[order], ev.time[order])


def _sub(ev, lo, hi, cls=Events):
    return cls(ev.edge_id[lo:hi], ev.pos[lo:hi], ev.time[lo:hi])


def _profile(engine="numpy", exact=True):
    eng, ex = ENGINES[engine]
    return ProfileConfig(solution="drfs", engine=eng, executor=ex, drfs_depth=DEPTH,
                         drfs_exact_leaf=exact, **KW)


def _srv(net, base, engine="numpy", exact=True, **kw):
    return TNKDEServer(net, base, {"default": _profile(engine, exact)}, device="cpu", **kw)


def _close(got, want, msg=""):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= TOL * scale, msg


class _Oracle:
    """The reference package's NumPy TNKDE, fed the server's mutations;
    pins taken at each admission give the expected answer wherever and
    whenever the server evaluates the request."""

    def __init__(self, seed, base_hi, exact=True, ev=None):
        net = ref_spatial.make_network(24, 40, seed=seed)
        self.ev = ev
        self.model = RefTNKDE(net, _sub(ev, 0, base_hi, RefEvents), solution="drfs",
                              engine="numpy", drfs_depth=DEPTH, drfs_exact_leaf=exact, **KW)
        self.pins, self.ts = {}, {}

    def insert(self, lo, hi):
        self.model.insert(_sub(self.ev, lo, hi, RefEvents))

    def pin(self, tag, ts):
        self.pins[tag] = self.model.snapshot()
        self.ts[tag] = ts

    def check(self, r):
        assert r.ok, f"tag={r.tag}: {r.error}"
        assert r.stats.epoch == self.pins[r.tag].epoch
        _close(r.heat, self.model.query(self.ts[r.tag], at=self.pins[r.tag]), f"tag={r.tag}")


# --------------------------------------------------- concurrency correctness
@pytest.mark.parametrize("exact", [True, False], ids=["exact_leaf", "quantized"])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("mode", ["microbatch", "continuous"])
def test_interleaved_mutations_match_pinned_oracle(mode, engine, exact):
    """insert / seal / compact between admissions; ONE late pump answers
    every request from its own pinned revision, equal to the reference at
    that snapshot."""
    net, ev = _world()
    srv = _srv(net, _sub(ev, 0, 100), engine, exact, mode=mode, batch_cap=4, n_slots=8)
    model = srv.models["default"]
    assert model.engine_desc == {"numpy": "numpy", "packed": "torch/packed",
                                 "fused": "torch/fused"}[engine]
    oracle = _Oracle(7, 100, exact, ev)

    def submit(tag):
        srv.submit(TS, tag=tag)
        oracle.pin(tag, TS)

    submit("t0")
    srv.insert(_sub(ev, 100, 130))  # pending only
    oracle.insert(100, 130)
    submit("t1")
    srv.insert(_sub(ev, 130, 200))  # crosses the geometric-seal threshold
    oracle.insert(130, 200)
    submit("t2")
    srv.seal()
    oracle.model.index.seal()
    submit("t3")
    srv.compact()
    oracle.model.compact()
    srv.insert(_sub(ev, 200, 215))
    oracle.insert(200, 215)
    submit("t4")
    assert len({p.epoch for p in oracle.pins.values()}) >= 4, "mutations must move epochs"
    resps = {r.tag: r for r in srv.pump()}
    assert set(resps) == set(oracle.pins)
    for r in resps.values():
        oracle.check(r)
    assert srv.n_queued == 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_pinned_result_stable_across_later_mutations(engine):
    """The same snapshot re-queried after further mutations is bit-stable."""
    net, ev = _world(seed=11)
    eng, ex = ENGINES[engine]
    m = TNKDE(net, _sub(ev, 0, 100), solution="drfs", engine=eng, executor=ex, drfs_depth=DEPTH,
              drfs_exact_leaf=False, device="cpu", **KW)
    snap = m.snapshot()
    before = m.query(TS, at=snap)
    m.insert(_sub(ev, 100, 170))
    m.index.seal()
    m.index.extend()
    after_live = m.query(TS)
    np.testing.assert_array_equal(before, m.query(TS, at=snap))
    assert not np.allclose(after_live, before), "live result must see inserts"


def test_slot_reuse_never_leaks_stale_rows_across_epochs():
    """More requests than slots, the same centers every round, an insert
    between rounds: recycled slots recompute at the new epoch and every
    round equals the reference at its pinned snapshot."""
    net, ev = _world()
    srv = _srv(net, _sub(ev, 0, 120), "fused", False, n_slots=4)  # 6 requests -> overflow
    oracle = _Oracle(7, 120, False, ev)
    cuts = [120, 150, 185, 215]
    for r in range(3):
        for k in range(6):
            srv.submit(TS, tag=(r, k))
            oracle.pin((r, k), TS)
        resps = srv.pump()
        assert len(resps) == 6
        for x in resps:
            oracle.check(x)
        assert srv.stats.n_rows_computed == len(TS) * (r + 1)
        assert srv.scheduler.slots_occupied == 0 and srv.n_queued == 0
        srv.insert(_sub(ev, cuts[r], cuts[r + 1]))
        oracle.insert(cuts[r], cuts[r + 1])
    assert srv.stats.n_flushes >= 6


# ----------------------------------------------------- batching + responses
@pytest.mark.parametrize("mode", ["microbatch", "continuous"])
def test_coalescing_one_pass_per_batch_and_correct_rows(mode):
    net, ev = _world(seed=13)
    srv = _srv(net, _sub(ev, 0, 150), "fused", False, mode=mode, batch_cap=8, window_cap=8)
    t_a, t_b, t_c = TS[0], TS[1], 4.0 * 86400.0
    srv.submit([t_a], tag="a")
    srv.submit([t_b, t_a], tag="ba")
    srv.submit([t_c], tag="c")
    resps = {r.tag: r for r in srv.pump()}
    assert srv.stats.n_batches == 1
    assert all(r.stats.batch_size == 3 for r in resps.values())
    assert srv.stats.n_rows_computed == 3
    assert srv.stats.n_windows_evaluated == window_class(3, 8) == 4
    ref = srv.models["default"].query([t_a, t_b, t_c])
    _close(resps["a"].heat, ref[:1])
    _close(resps["ba"].heat, np.stack([ref[1], ref[0]]))
    _close(resps["c"].heat, ref[2:3])


def test_result_cache_hit_and_epoch_invalidation():
    net, ev = _world(seed=17)
    srv = _srv(net, _sub(ev, 0, 150), "fused", False)
    srv.submit(TS, tag="cold")
    cold = {r.tag: r for r in srv.pump()}["cold"]
    assert cold.stats.cache_hits == 0 and cold.stats.windows_evaluated > 0
    srv.submit(TS, tag="warm")
    warm = {r.tag: r for r in srv.pump()}["warm"]
    assert warm.stats.cache_hits == len(TS) and warm.stats.windows_evaluated == 0
    np.testing.assert_array_equal(warm.heat, cold.heat)
    srv.insert(_sub(ev, 150, 160))  # epoch moves -> natural invalidation
    srv.submit(TS, tag="stale")
    stale = {r.tag: r for r in srv.pump()}["stale"]
    assert stale.stats.cache_hits == 0 and stale.stats.epoch != cold.stats.epoch


def test_lixel_subset_and_mixed_epochs():
    net, ev = _world(seed=19)
    srv = _srv(net, _sub(ev, 0, 120), "numpy", False, mode="microbatch", batch_cap=8)
    lix = np.array([0, 5, 11])
    srv.submit([TS[0]], lixels=lix, tag="sub")
    srv.submit([TS[0]], tag="full")
    resps = {r.tag: r for r in srv.pump()}
    assert resps["sub"].heat.shape == (1, 3)
    np.testing.assert_array_equal(resps["sub"].heat, resps["full"].heat[:, lix])
    n0 = srv.stats.n_batches
    srv.submit([TS[0]], tag=0)
    srv.insert(_sub(ev, 120, 140))
    srv.submit([TS[0]], tag=1)
    epochs = {r.tag: r.stats.epoch for r in srv.pump()}
    assert srv.stats.n_batches == n0 + 2 and epochs[0] != epochs[1]


def test_insert_requires_streaming_profiles_and_rfs_query_at():
    net, ev = _world(seed=29, n_events=80)
    srv = TNKDEServer(net, ev, {"static": ProfileConfig(solution="rfs", **KW)}, device="cpu")
    with pytest.raises(ValueError, match="static"):
        srv.insert(ev)
    with pytest.raises(ValueError, match="drfs"):
        srv.models["static"].query(TS, at=object())


def test_window_class_values():
    assert [window_class(n, 8) for n in (1, 2, 3, 4, 5, 7, 8)] == [1, 2, 4, 4, 6, 8, 8]
    assert window_class(11, 8) == 12


def test_warmup_and_compile_audit_keys():
    """``warmup()`` probes the widest window class once per profile (the
    kernels take the window count at run time) and reports the compile
    audit (CUDA libraries loaded in this process: none on the CPU, where
    the wrappers run the plain versions); steady-state serving at every
    width adds none."""
    net, ev = _world()
    srv = _srv(net, _sub(ev, 0, 200), "fused", False, window_cap=8)
    w = srv.warmup()
    assert w["window_classes"] == [8] and w["profiles"] == {"default": [8]}
    assert w["jit_entries_before"] == w["jit_entries_after"] == jit_entries() == 0
    rng = np.random.default_rng(3)
    for n in (1, 3, 8, 5):
        srv.submit([float(t) for t in rng.uniform(1.5 * 86400.0, 7.5 * 86400.0, n)])
        assert all(r.ok for r in srv.pump())
    assert srv.stats_json()["jit_entries"] == 0


def test_slo_admission_expired_and_hopeless_sheds():
    net, ev = _world()
    srv = _srv(net, _sub(ev, 0, 150), "fused", False, slo_margin=1.0)
    srv.submit(TS, tag="prime")
    (r,) = srv.pump()
    assert r.ok and srv.continuous.flush_ewma_s is not None
    srv.continuous.flush_ewma_s = 10.0
    srv.submit(TS, tag="hopeless", deadline_s=1.0)
    srv.submit(TS, tag="expired", deadline_s=1e-9)
    resps = {r.tag: r for r in srv.pump()}
    h, x = resps["hopeless"], resps["expired"]
    assert not h.ok and h.error.code == "deadline_hopeless" and h.error.retryable
    assert not x.ok and x.error.code == "deadline_exceeded"
    assert srv.stats.n_hopeless_shed == 1 and srv.stats.n_expired == 1
    assert srv.stats.n_rows_computed == len(TS)


# ------------------------------------------------------------- load drivers
def test_make_request_mix_equals_the_reference():
    net, ev = _world()
    stream = _sub(ev, 200, 240)
    kw = dict(n_requests=11, stream_every=3, max_windows=3, seed=7)
    port = make_request_mix(stream, 86400.0, 8 * 86400.0, **kw)
    ref = ref_serve.make_request_mix(_sub(ev, 200, 240, RefEvents), 86400.0, 8 * 86400.0, **kw)
    assert [type(i).__name__ for i in port] == [type(i).__name__ for i in ref]
    for a, b in zip(port, ref):
        if isinstance(a, QueryItem):
            assert list(a.ts) == list(b.ts) and a.profile == b.profile
        else:
            for f in ("edge_id", "pos", "time"):
                np.testing.assert_array_equal(getattr(a.events, f), getattr(b.events, f))


def test_load_drivers_agree_with_the_reference():
    """run_server (both cores) and run_sequential end at the reference's
    final state; open-loop accounting and its rate contract."""
    net, ev = _world(seed=37)
    base, tail = _sub(ev, 0, 150), _sub(ev, 150, 190)
    mix = [QueryItem(ts=[TS[0]]), QueryItem(ts=[TS[0], TS[1]]), InsertItem(tail),
           QueryItem(ts=[TS[1]])]
    ref = RefTNKDE(ref_spatial.make_network(24, 40, seed=37), _sub(ev, 0, 150, RefEvents),
                   solution="drfs", engine="numpy", drfs_depth=DEPTH, drfs_exact_leaf=False, **KW)
    ref.insert(_sub(ev, 150, 190, RefEvents))
    want = ref.query(TS)
    for mode in ("microbatch", "continuous"):
        srv = _srv(net, base, "fused", False, mode=mode, batch_cap=4)
        rep = run_server(srv, mix)
        assert rep.latencies.shape == (3,) and rep.summary()["n"] == 3
        _close(srv.models["default"].query(TS), want)
    seq_model = TNKDE(net, base, device="cpu", **_profile("fused", False).to_kwargs())
    assert run_sequential(seq_model, mix).latencies.shape == (3,)
    _close(seq_model.query(TS), want)
    srv = _srv(net, base, "fused", False, n_slots=8)
    rep = run_open_loop(srv, mix, rate_hz=500.0)
    assert len(rep.latencies) == 3 and rep.n_errors == 0 and rep.n_shed == 0
    assert rep.summary()["offered_rate_hz"] == 500.0
    with pytest.raises(ValueError, match="finite positive rate"):
        run_open_loop(srv, mix, rate_hz=None)


# ---------------------------------------------------------- the TNKDE API
@pytest.mark.parametrize("method", ["degrade", "attach_wal", "checkpoint", "restore"])
def test_a6_a7_methods_are_served(tmp_path, method):
    """The four methods that raised NotImplementedError before the
    durability/serve slice are served on DRFS and, as in the reference,
    the three durability methods are refused with ValueError on RFS
    (``degrade`` serves RFS too: on the host path it is on the floor)."""
    from repro_torch.core import WriteAheadLog

    net, ev = _world(n_events=80)
    rfs = TNKDE(net, ev, solution="rfs", engine="numpy", **KW)
    args = {"degrade": (), "attach_wal": (WriteAheadLog(str(tmp_path / "w")),),
            "checkpoint": (str(tmp_path / "c"),), "restore": (None,)}[method]
    if method == "degrade":
        assert rfs.degrade() is None
    else:
        with pytest.raises(ValueError, match=f"{method}\\(\\) requires solution='drfs'"):
            getattr(rfs, method)(*args)
    d = TNKDE(net, ev, solution="drfs", engine="torch", executor="fused", drfs_depth=3,
              device="cpu", **KW)
    out = getattr(d, method)(*args)
    if method == "degrade":
        assert out == d.engine_desc == "torch/packed"
    elif method == "checkpoint":
        assert out == 1 and d.epoch[0] >= 1
    elif method == "restore":
        assert out.restored_step is None and out.n_records == 0


def test_degrade_ladder_walks_to_the_floor():
    """``torch/fused`` (and ``torch/kernel``) → ``torch/packed`` →
    ``numpy`` → None; every rung answers as the reference does."""
    net, ev = _world()
    base = _sub(ev, 0, 150)
    want = RefTNKDE(ref_spatial.make_network(24, 40, seed=7), _sub(ev, 0, 150, RefEvents),
                    solution="drfs", engine="numpy", drfs_depth=DEPTH, **KW).query(TS)
    for ex in ("fused", "kernel"):
        m = TNKDE(net, base, solution="drfs", engine="torch", executor=ex, drfs_depth=DEPTH,
                  device="cpu", **KW)
        assert m.engine_desc == f"torch/{ex}"
        steps = [m.engine_desc]
        while True:
            _close(m.query(TS), want)
            d = m.degrade()
            if d is None:
                break
            steps.append(d)
        assert steps == [f"torch/{ex}", "torch/packed", "numpy"]
        assert m.degrade() is None


def test_degrade_stops_at_packed_on_the_card():
    """On the card the ladder ends at ``torch/packed``: ``degrade()`` there
    returns None and keeps the engine, rather than moving the work to the
    host (the rule reads the engine's device; here the CPU engine is
    relabelled, since no card is present)."""
    import torch

    net, ev = _world()
    m = TNKDE(net, _sub(ev, 0, 150), solution="drfs", engine="torch", executor="fused",
              drfs_depth=DEPTH, device="cpu", **KW)
    assert m.degrade() == "torch/packed"
    fe = m._fe
    fe.device = torch.device("cuda")
    assert m.degrade() is None
    assert m._fe is fe and m.engine_desc == "torch/packed"


# --------------------------------------------------------------- launcher
def test_cli_flags_reach_serve_tnkde(monkeypatch):
    got = {}
    monkeypatch.setattr(launch, "serve_tnkde", lambda **kw: got.update(kw))
    launch.main(["--workload", "tnkde", "--requests", "9", "--microbatch", "--replicas", "3",
                 "--slo-ms", "250", "--slots", "16", "--open-loop", "--rate", "5",
                 "--no-warmup", "--hedge-ms", "50", "--resync", "--executor", "packed",
                 "--device", "cpu"])
    assert got["mode"] == "microbatch" and got["n_slots"] == 16
    assert got["replicas"] == 3 and got["slo_ms"] == 250.0 and got["hedge_ms"] == 50.0
    assert got["open_loop"] is True and got["warmup"] is False and got["resync"] is True
    assert got["rate_hz"] == 5.0 and got["n_requests"] == 9
    assert got["executor"] == "packed" and got["device"] == "cpu"
    got.clear()
    launch.main([])  # defaults: tnkde, continuous, warm, 1 replica, fused on the card
    assert got["mode"] == "continuous" and got["warmup"] is True and got["replicas"] == 1
    assert got["executor"] == "fused" and got["device"] == "cuda" and got["hedge_ms"] is None


def test_serve_tnkde_on_cpu_durable_then_restored(tmp_path, monkeypatch):
    """``serve_tnkde(device='cpu')`` answers a few requests without and
    with durability: a durable run checkpoints, a second run restores
    (checkpoint + WAL replay), warms against the recovered state and
    serves; a replicated run serves through the router."""
    net, ev = _world(n_events=300)
    meta = {"V": net.n_vertices, "E": net.n_edges, "N": ev.n}
    monkeypatch.setattr(port_spatial, "make_dataset", lambda *a, **k: (net, ev, meta))
    logs = []
    lat = launch.serve_tnkde(n_requests=4, device="cpu", warmup=False, log_fn=logs.append)
    assert len(lat) == 4 and any("engine=torch/fused" in m for m in logs)
    wal, ckpt = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    logs.clear()
    lat1 = launch.serve_tnkde(n_requests=6, device="cpu", wal_dir=wal, ckpt_dir=ckpt,
                              warmup=False, log_fn=logs.append)
    assert len(lat1) == 6 and any("checkpointed" in m for m in logs)
    logs.clear()
    lat2 = launch.serve_tnkde(n_requests=6, device="cpu", wal_dir=wal, ckpt_dir=ckpt,
                              restore=True, slo_ms=60000.0, warmup=True, log_fn=logs.append)
    assert len(lat2) == 6
    assert any("recovered" in m for m in logs) and any("warmup" in m for m in logs)
    logs.clear()
    lat3 = launch.serve_tnkde(n_requests=4, device="cpu", replicas=2, executor="packed",
                              warmup=False, log_fn=logs.append)
    assert len(lat3) == 4 and any("fleet:" in m for m in logs)


def test_router_epoch_consistent_routing():
    net, ev = _world()
    router = ReplicaRouter(net, _sub(ev, 0, 100), {"default": _profile("fused", False)},
                           replicas=2, n_slots=8, device="cpu")
    router.insert(_sub(ev, 100, 160))
    router.seal()
    assert len({s.models["default"].epoch for s in router.servers}) == 1
    placed = [router.submit(TS, tag=k)[0] for k in range(4)]
    assert set(placed) == {0, 1}
    resps = router.pump()
    oracle = _Oracle(7, 100, False, ev)
    oracle.insert(100, 160)
    oracle.model.index.seal()
    want = oracle.model.query(TS)
    assert len(resps) == 4
    for r in resps:
        assert r.ok
        _close(r.heat, want)
    assert router.stats_json()["n_requests"] == 4 and router.n_queued == 0
