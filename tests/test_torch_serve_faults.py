"""Fault isolation of the port's serve tier (the reference's
``test_serve_faults.py`` and the fault cases of
``test_serve_continuous.py``, re-pointed at ``repro_torch``): every
admitted request gets exactly one Response, the pump never raises,
deadlines and load shedding bound the work, and repeated engine faults
trip the degradation ladder ``torch/fused`` → ``torch/packed`` → ``numpy``
while the next rung keeps serving, equal to the reference's NumPy engine
within ``TOL`` (1e-12 relative to max|F|). The port runs on the CPU.
"""
import time

import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core.events import Events
from repro_torch.ft.faults import inject_query_faults
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.serve import (
    InsertItem,
    ProfileConfig,
    QueryItem,
    QueueFull,
    TNKDEServer,
    jit_entries,
    run_server,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TS = [2.5 * 86400.0, 6.0 * 86400.0]
TOL = 1e-12
CFG = dict(g=40.0, b_s=600.0, b_t=2 * 86400.0, solution="drfs", drfs_depth=4)


def _world(seed=7, n_events=160):
    net = port_spatial.make_network(24, 40, seed=seed)
    return net, port_spatial.make_events(net, n_events, seed=seed, span_days=8.0)


def _reference(ev, cfg=CFG, seed=7):
    net = ref_spatial.make_network(24, 40, seed=seed)
    return RefTNKDE(net, RefEvents(ev.edge_id, ev.pos, ev.time), engine="numpy", **cfg)


def _close(got, want):
    assert float(np.abs(got - want).max()) <= TOL * max(float(np.abs(want).max()), 1e-300)


def _server(net, ev, mode="microbatch", **kw):
    kw.setdefault("retry_backoff_s", 0.0)
    prof = ProfileConfig(engine="torch", executor="fused", **CFG)
    return TNKDEServer(net, ev, {"default": prof}, mode=mode, device="cpu", **kw)


MODES = ["microbatch", "continuous"]


@pytest.mark.parametrize("mode", MODES)
def test_every_admitted_request_answered_on_engine_fault(mode):
    net, ev = _world()
    srv = _server(net, ev, mode)
    calls = inject_query_faults(srv.models["default"], fail_on={0})
    ids = [srv.submit(TS, tag=k) for k in range(3)]
    rs = srv.pump()
    assert {r.tag for r in rs} == {0, 1, 2} and {r.id for r in rs} == set(ids)
    assert all((not r.ok) and r.error.code == "engine_fault" and r.heat is None for r in rs)
    assert all(not r.error.retryable for r in rs) and calls() == 1  # no retry
    assert srv.n_queued == 0 and srv.stats.n_errors == 3 and srv.stats.n_engine_faults == 1
    srv.submit(TS, tag="after")
    (r,) = srv.pump()
    assert r.ok and r.heat.shape == (2, srv.models["default"].n_lixels)
    _close(r.heat, _reference(ev).query(TS))


def test_fault_isolated_to_its_profile():
    net, ev = _world()
    good = dict(CFG)
    bad = dict(CFG, b_s=500.0, b_t=86400.0, drfs_depth=3)
    profs = {"good": ProfileConfig(engine="torch", executor="fused", **good),
             "bad": ProfileConfig(engine="torch", executor="fused", **bad)}
    srv = TNKDEServer(net, ev, profs, retry_backoff_s=0.0, device="cpu")
    inject_query_faults(srv.models["bad"], fail_on=set(range(8)))
    srv.submit(TS, profile="bad", tag="b")
    srv.submit(TS, profile="good", tag="g")
    rs = {r.tag: r for r in srv.pump()}
    assert not rs["b"].ok and rs["g"].ok
    _close(rs["g"].heat, _reference(ev, good).query(TS))


@pytest.mark.parametrize("mode", MODES)
def test_transient_fault_retried_once(mode):
    net, ev = _world()
    srv = _server(net, ev, mode)
    calls = inject_query_faults(srv.models["default"], fail_on={0}, transient=True)
    srv.submit(TS, tag=0)
    (r,) = srv.pump()
    assert r.ok and calls() == 2  # fault + one retry
    assert srv.stats.n_retries == 1 and srv.stats.n_engine_faults == 1 and srv.stats.n_errors == 0
    _close(r.heat, _reference(ev).query(TS))


def test_persistent_transient_fault_still_isolated():
    net, ev = _world()
    srv = _server(net, ev)
    calls = inject_query_faults(srv.models["default"], fail_on={0, 1}, transient=True)
    srv.submit(TS, tag=0)
    (r,) = srv.pump()
    assert not r.ok and r.error.retryable and calls() == 2
    assert srv.stats.n_retries == 1 and srv.stats.n_engine_faults == 2


def test_card_server_never_degrades_by_itself():
    """``degrade_after`` defaults to the reference's 2 on the CPU; on the
    card it is off, and asking for it there is refused before any model is
    built: a failed kernel fails its flush, nothing falls back silently."""
    net, ev = _world()
    assert _server(net, ev).degrade_after == 2
    assert _server(net, ev, degrade_after=5).degrade_after == 5
    prof = ProfileConfig(engine="torch", executor="fused", **CFG)
    with pytest.raises(ValueError, match="degrade_after is off on the card"):
        TNKDEServer(net, ev, {"default": prof}, device="cuda", degrade_after=2)


@pytest.mark.parametrize("mode", MODES)
def test_degradation_ladder_trips_and_serves(mode):
    """Two consecutive faulting flushes trip ``torch/fused`` → ``torch/packed``,
    two more ``torch/packed`` → ``numpy``; each rung then serves the
    reference's answer, and the ladder loads no library."""
    net, ev = _world()
    srv = _server(net, ev, mode, degrade_after=2)
    model = srv.models["default"]
    assert model.engine_desc == "torch/fused"
    inject_query_faults(model, fail_on={0, 1, 3, 4})
    want = _reference(ev).query(TS)
    j0 = jit_entries()
    for rung, desc in ((1, "torch/packed"), (2, "numpy")):
        for k in range(2):
            srv.submit(TS, tag=(rung, k))
            (r,) = srv.pump()
            assert not r.ok
        assert srv.stats.n_degradations == rung and model.engine_desc == desc
        srv.submit([TS[0], TS[1] + rung], tag=("ok", rung))
        (r,) = srv.pump()
        assert r.ok
        _close(r.heat[:1], want[:1])
    assert jit_entries() == j0


@pytest.mark.parametrize("mode", MODES)
def test_bounded_queue_sheds_with_typed_error(mode):
    net, ev = _world()
    srv = _server(net, ev, mode, max_queued=3)
    for k in range(3):
        srv.submit(TS, tag=k)
    with pytest.raises(QueueFull) as ei:
        srv.submit(TS, tag=99)
    assert ei.value.retryable and ei.value.code == "queue_full" and srv.stats.n_shed == 1
    rs = srv.pump()
    assert len(rs) == 3 and all(r.ok for r in rs)
    srv.submit(TS, tag="again")
    assert srv.n_queued == 1


def test_unbounded_by_default():
    net, ev = _world()
    srv = _server(net, ev)
    for k in range(64):
        srv.submit(TS, tag=k)
    assert srv.n_queued == 64 and srv.stats.n_shed == 0


@pytest.mark.parametrize("mode", MODES)
def test_deadline_expiry_pre_execution(mode):
    net, ev = _world()
    srv = _server(net, ev, mode)
    srv.submit(TS, tag="dead", deadline_s=0.001)
    srv.submit(TS, tag="live")
    time.sleep(0.01)
    rs = {r.tag: r for r in srv.pump()}
    assert not rs["dead"].ok and rs["dead"].error.code == "deadline_exceeded"
    assert rs["live"].ok and srv.stats.n_expired == 1
    assert rs["live"].stats.windows_evaluated <= len(TS)
    srv2 = _server(net, ev, mode, default_deadline_s=0.001)
    srv2.submit(TS, tag=0)
    time.sleep(0.01)
    (r,) = srv2.pump()
    assert not r.ok and r.error.code == "deadline_exceeded"


@pytest.mark.parametrize("mode", MODES)
def test_slow_flush_counts_straggler(mode):
    net, ev = _world()
    srv = _server(net, ev, mode, watchdog=StepWatchdog(hard_timeout=0.05))
    inject_query_faults(srv.models["default"], slow_on={0}, slow_s=0.2)
    srv.submit(TS, tag=0)
    (r,) = srv.pump()
    assert r.ok and srv.stats.n_stragglers == 1


def test_run_server_with_shedding_and_faults():
    net, ev = _world()
    rng = np.random.default_rng(0)
    workload = []
    for k in range(12):
        workload.append(QueryItem(ts=[float(rng.uniform(2e5, 6e5))]))
        if k == 5:
            e = rng.integers(0, net.n_edges, 10).astype(np.int32)
            workload.append(InsertItem(Events(e, rng.uniform(0, net.edge_len[e]),
                                              np.sort(rng.uniform(7e5, 7.1e5, 10)))))
    srv = _server(net, ev, "continuous")
    inject_query_faults(srv.models["default"], fail_on={0})
    rep = run_server(srv, workload, rate_hz=None)
    s = rep.summary()
    assert rep.n_errors >= 1 and rep.n_errors + rep.n_shed + s["n"] == 12
    assert s["n"] > 0 and "p99_ms" in s and s["n_errors"] == rep.n_errors
    srv2 = _server(net, ev, "continuous", max_queued=2)
    rep2 = run_server(srv2, [QueryItem(ts=[3e5 + k]) for k in range(10)], rate_hz=None)
    assert rep2.n_shed == srv2.stats.n_shed > 0
    assert rep2.n_errors + rep2.n_shed + rep2.summary()["n"] == 10


@pytest.mark.parametrize("mode", MODES)
def test_pump_never_raises_even_on_internal_bug(mode):
    net, ev = _world()
    srv = _server(net, ev, mode)
    srv.submit(TS, tag=0)
    srv.submit(TS, tag=1)
    srv.cache = None  # sabotage something the pump touches outside the engine pass
    rs = srv.pump()
    assert {r.tag for r in rs} == {0, 1}
    assert all((not r.ok) and r.error.code == "internal" for r in rs)
    assert srv.n_queued == 0
