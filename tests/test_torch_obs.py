"""The port's host spans (``repro_torch.obs``) on the CPU: nothing is
recorded without a profiler; under one, a query gives the tree
``tnkde.dispatch`` ⊃ {plan, window_batch, tables, packs, launch} and
``tnkde.result`` ⊃ wait with one shared query id, every record lies on the
profiler's clock, a continuous server's flush spans carry the ids of the
responses it returned, and the buffer is bounded."""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import repro_torch.data.spatial as port_spatial
from repro_torch import obs
from repro_torch.core import TNKDE
from repro_torch.serve import ProfileConfig, TNKDEServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0)
TS = [2.5 * 86400.0, 6.0 * 86400.0]
TS_NEW = [3.0 * 86400.0, 7.5 * 86400.0]
FRONT_END = ("tnkde.plan", "tnkde.window_batch", "tnkde.tables", "tnkde.packs",
             "tnkde.launch")


@pytest.fixture(scope="module")
def world():
    net = port_spatial.make_network(24, 40, seed=7)
    return net, port_spatial.make_events(net, 240, seed=8, span_days=9)


@pytest.fixture(autouse=True)
def empty_buffer():
    obs.clear()
    yield
    obs.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _model(world, executor="fused"):
    net, ev = world
    return TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu",
                 **KW)


def _server(world, **kw):
    net, ev = world
    prof = ProfileConfig(solution="rfs", engine="torch", executor="fused", **KW)
    return TNKDEServer(net, ev, {"p": prof}, device="cpu", **kw)


def _children(recs, rec):
    return [r for r in recs if r.parent == rec.id]


@pytest.mark.parametrize("path", ["query", "serve"])
def test_no_profiler_records_nothing(world, path):
    with obs.span("probe", a=1) as sp:
        assert sp is None
    assert obs.span("a") is obs.span("b")  # the shared no-op
    if path == "query":
        m = _model(world)
        m.query(TS)
        m.dispatch(TS_NEW).result()
    else:
        srv = _server(world)
        for i, t in enumerate(TS + TS_NEW):
            srv.submit([t], profile="p", tag=i)
        assert len(srv.pump()) == 4
    assert obs.records() == [] and obs.dropped() == 0


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
def test_query_span_tree(world, executor):
    m = _model(world, executor)
    m.query(TS)  # plan and packs cached before the profiled queries
    s0 = m._fe.counters["rank_searches"]
    with _cpu_profile():
        p_new = m.dispatch(TS_NEW)
        F_new = p_new.result()
        F_rep = m.query(TS_NEW)
    recs = obs.records()
    np.testing.assert_array_equal(F_new, F_rep)
    # one fold over every node on the new ts (the kernel executor: one rank
    # table over the edges instead), none on the repeat
    fe = m._fe
    searched = fe._packed["n_nodes"] if executor != "kernel" else fe.rf.net.n_edges
    assert fe.counters["rank_searches"] - s0 == 3 * len(TS_NEW) * searched
    dispatches = sorted((r for r in recs if r.name == "tnkde.dispatch"), key=lambda r: r.t0_ns)
    results = sorted((r for r in recs if r.name == "tnkde.result"), key=lambda r: r.t0_ns)
    assert len(dispatches) == len(results) == 2
    assert dispatches[0].attrs["query"] == p_new._query
    for d, res, new in zip(dispatches, results, (True, False)):
        assert d.parent is None and res.parent is None
        assert d.attrs["query"] == res.attrs["query"] and d.attrs["windows"] == len(TS_NEW)
        kids = {r.name: r for r in _children(recs, d)}
        assert sorted(kids) == sorted(FRONT_END)
        for r in kids.values():
            assert d.t0_ns <= r.t0_ns <= r.t1_ns <= d.t1_ns
        assert kids["tnkde.plan"].attrs["hit"] and kids["tnkde.packs"].attrs["hit"]
        assert kids["tnkde.window_batch"].attrs["hit"] is not new
        assert kids["tnkde.tables"].attrs["hit"] is not new
        assert kids["tnkde.tables"].attrs["launches"] == 0  # the plain fold on the CPU
        launch = kids["tnkde.launch"].attrs
        assert launch["packs"] > 0 and launch["launches"] == 0  # plain versions on the CPU
        assert [r.name for r in _children(recs, res)] == ["tnkde.wait"]
    assert {d.attrs["query"] for d in dispatches} == {p_new._query, p_new._query + 1}


def test_records_lie_on_the_profiler_clock(world):
    m = _model(world)
    m.query(TS)
    with _cpu_profile() as prof:
        m.query(TS_NEW)
        m.query(TS)
    recs = obs.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(obs.PREFIX)]
    assert len(recs) == len(events) == 16
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.t0_ns)
        theirs = sorted((e for e in events if e.name() == obs.PREFIX + name),
                        key=lambda e: e.start_ns())
        assert len(mine) == len(theirs), name
        for r, e in zip(mine, theirs):
            assert abs(r.t0_ns - e.start_ns()) < 1_000_000, name
            assert abs(r.t1_ns - (e.start_ns() + e.duration_ns())) < 1_000_000, name


def test_serve_spans_carry_the_response_ids(world):
    srv = _server(world, window_cap=4)
    srv.warmup()
    rng = np.random.default_rng(5)
    with _cpu_profile():
        for i in range(9):
            srv.submit(list(rng.uniform(1.0, 8.0, 1 + i % 3) * 86400.0), profile="p", tag=i)
        out = srv.pump()
    recs = obs.records()
    by_id = {r.id: r for r in recs}
    disp = [r for r in recs if r.name == "serve.dispatch"]
    ret = [r for r in recs if r.name == "serve.retire"]
    assert len(disp) == len(ret) >= 3
    assert sorted(r.attrs["flush"] for r in disp) == sorted(r.attrs["flush"] for r in ret)
    assert sorted(i for r in disp for i in r.attrs["requests"]) == sorted(r.id for r in out)
    assert all(r.ok for r in out) and len(out) == 9
    for d in disp:
        a = d.attrs
        assert 0 < a["misses"] <= a["centres"] <= a["window_class"] <= 4
        (q,) = [r for r in _children(recs, d) if r.name == "tnkde.dispatch"]
        assert q.attrs["windows"] == a["window_class"]
    for name, under in (("tnkde.result", "serve.retire"), ("tnkde.wait", "tnkde.result")):
        rs = [r for r in recs if r.name == name]
        assert len(rs) == len(disp) and all(by_id[r.parent].name == under for r in rs)


def test_buffer_bound_counts_dropped(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    with _cpu_profile():
        for i in range(5):
            with obs.span("outer", i=i) as sp:
                sp["seen"] = True
    recs = obs.records()
    assert [r.attrs["i"] for r in recs] == [0, 1, 2] and obs.dropped() == 2
    assert all(r.attrs["seen"] and r.parent is None for r in recs)
    obs.clear()
    assert obs.records() == [] and obs.dropped() == 0
