"""The streaming DRFS index in its exact profile with a day's feed pending,
on the CPU at a small scale of the benchmark's berkeley replica: built from
the history, the last 24 h inserted in hourly batches (nothing sealed), it
answers exact TN-KDE over the whole event set, with or without the feed in
the windows, and as an index built from every event at once does. Under a
profiler the engine's spans nest ``tnkde.dispatch`` ⊃ ``tnkde.tables`` and
``tnkde.launch`` ⊃ ``tnkde.scan``; without one nothing is recorded and the
answers are the same bits."""
import dataclasses
import os
import sys

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch import obs  # noqa: E402
from repro_torch.core import TNKDE  # noqa: E402
from tnkde_bench.harness.dataset import make_dataset  # noqa: E402
from tnkde_bench.harness.program import network_and_events  # noqa: E402
from tnkde_bench.reference.tnkde_ref import exact_heat, lixel_geometry  # noqa: E402
from tnkde_bench.traffic import fed_closed_loop as fed  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse fixture)

TABLE3 = {"V": 1576, "E": 4378, "N": 735366}  # berkeley
SCALE = 0.01
DAY = 86400.0
G, B_S = 50.0, 800.0


@pytest.fixture(scope="module")
def ds():
    return make_dataset(TABLE3, SCALE, 0)


def _b_t(ds):
    return 0.2 * ds.t_span


def _model(ds, keep, executor):
    sub = dataclasses.replace(ds, ev_edge=ds.ev_edge[keep], ev_pos=ds.ev_pos[keep],
                              ev_time=ds.ev_time[keep])
    net, ev = network_and_events(sub)
    return TNKDE(net, ev, g=G, b_s=B_S, b_t=_b_t(ds), solution="drfs", engine="torch",
                 executor=executor, drfs_depth=8, drfs_exact_leaf=True, auto_seal=True,
                 device="cpu")


def _fed(ds, executor):
    """The cell's index: the history built, the last day fed in 24 batches."""
    t_cut = float(ds.ev_time.max()) - DAY
    hist = ds.ev_time <= t_cut
    m = _model(ds, hist, executor)
    batches = fed._feed_batches(ds, t_cut, DAY, 24)
    for idx in batches:
        m.insert(fed._events(ds, idx))
    return m, hist, batches


@pytest.fixture(scope="module")
def fused(ds):
    return _fed(ds, "fused")


def _windows(ds, overlap):
    """Three centres whose windows reach into the fed day, or end before it."""
    t_max, b_t = float(ds.ev_time.max()), _b_t(ds)
    if overlap:
        return [t_max - 0.25 * DAY, t_max - 3.0 * DAY, t_max - 0.5 * b_t]
    return [ds.t_min + 2.0 * DAY, ds.t_min + 0.5 * ds.t_span, t_max - DAY - 1.05 * b_t]


def _exact(ds, ts, keep=None):
    """The plain reference over every event, or over ``keep``'s (the same b_t)."""
    b_t = _b_t(ds)
    if keep is not None:
        ds = dataclasses.replace(ds, ev_edge=ds.ev_edge[keep], ev_pos=ds.ev_pos[keep],
                                 ev_time=ds.ev_time[keep])
    L = lixel_geometry(ds.edge_len, G)[0].shape[0]
    return exact_heat(ds, g=G, b_s=B_S, b_t=b_t, lixels=np.arange(L), ts=ts).T


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_feed_is_pending_in_hourly_batches(ds, fused):
    m, hist, batches = fused
    tail = int((~hist).sum())
    assert tail > 0 and m.index.n_pending == tail and m.index.n_sealed == int(hist.sum())
    assert 1 < len(batches) <= 24 and sum(b.shape[0] for b in batches) == tail
    times = np.concatenate([ds.ev_time[b] for b in batches])
    assert (np.diff(times) >= 0).all()  # time order, within and across batches


@pytest.mark.parametrize("overlap", [True, False], ids=["feed-in-window", "history-only"])
@pytest.mark.parametrize("executor", ["fused", "kernel", "packed"])
def test_fed_index_is_exact_over_every_event(ds, fused, overlap, executor):
    m, hist, _ = fused if executor == "fused" else _fed(ds, executor)
    ts = _windows(ds, overlap)
    F = m.query(ts)
    want = _exact(ds, ts)
    assert _rel(F, want) <= 1e-12
    # the feed decides the answer exactly where a window reaches it
    hidden = _rel(_exact(ds, ts, hist), want)
    assert (hidden > 1e-6) if overlap else (hidden <= 1e-14)
    if executor == "fused":
        assert m.stats.n_pending_scanned > 0 and m.stats.n_partial_scanned > 0


@pytest.mark.parametrize("overlap", [True, False], ids=["feed-in-window", "history-only"])
def test_fed_index_equals_one_built_at_once(ds, fused, overlap):
    m, _, _ = fused
    whole = _model(ds, np.ones(ds.n_events, bool), "fused")
    assert whole.index.n_pending == 0
    ts = _windows(ds, overlap)
    assert _rel(m.query(ts), whole.query(ts)) <= 1e-12


def _children(recs, rec, name):
    return [r for r in recs if r.parent == rec.id and r.name == name]


def test_engine_spans_nest_under_a_profiler_only(ds, fused):
    m, _, _ = fused
    ts = [ds.t_min + 10.0 * DAY, float(ds.ev_time.max()) - 2.0 * DAY]
    obs.clear()
    try:
        F_off = m.query(ts)  # fresh ts tuple, no profiler: nothing recorded
        assert obs.records() == []
        with profile(activities=[ProfilerActivity.CPU]):
            F_on = m.query(ts)
            F_new = m.query([t + DAY for t in ts])
        recs = obs.records()
    finally:
        obs.clear()
    np.testing.assert_array_equal(F_on, F_off)  # the spans change no bit
    assert _rel(F_new, _exact(ds, [t + DAY for t in ts])) <= 1e-12
    dispatches = sorted((r for r in recs if r.name == "tnkde.dispatch"), key=lambda r: r.t0_ns)
    assert len(dispatches) == 2
    for d, new in zip(dispatches, (False, True)):
        (tables,) = _children(recs, d, "tnkde.tables")
        (launch,) = _children(recs, d, "tnkde.launch")
        assert tables.attrs["hit"] is not new
        assert launch.attrs["blocks"] > 0 and launch.attrs["launches"] == 0  # plain on the CPU
        scans = _children(recs, launch, "tnkde.scan")
        assert len(scans) == launch.attrs["blocks"]
        for r in (tables, launch, *scans):
            assert d.t0_ns <= r.t0_ns <= r.t1_ns <= d.t1_ns
        for s in scans:
            assert launch.t0_ns <= s.t0_ns <= s.t1_ns <= launch.t1_ns
            assert s.attrs["scan_steps"] > 0 and s.attrs["pend_steps"] > 0
    assert all(r.parent is not None for r in recs if r.name == "tnkde.scan")
