"""Closed-loop traffic over a streaming index with a day's feed pending:
``closed_loop``'s analyst, on a Dynamic Range Forest (``solution='drfs'``)
built from the history, with the configuration's ``feed`` inserted after it.

Set-up builds the index from the events up to ``tail_s`` seconds before the
last one (span ``build``), replays the rest in ``batches`` time-ordered
``TNKDE.insert`` calls of equal spans of time (span ``feed``), and raises
unless every fed event is pending, none sealed and none lost. The queries
then read an index whose feed is still pending, so the event set of every
answer is the cell's whole dataset, which ``correct`` checks against.

Parameters (the cell's ``params``) and the measured window are
``closed_loop``'s; the window also counts the (atom, event) pairs the
streaming scans examined (``QueryStats.n_partial_scanned +
n_pending_scanned``), as the counter ``scan_pairs``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from tnkde_bench.harness import roofline_drfs
from tnkde_bench.harness.program import model_kwargs, network_and_events
from tnkde_bench.traffic import closed_loop

DRFS_KEYS = ("drfs_depth", "drfs_h0", "drfs_exact_leaf", "auto_seal", "horizon_s")


def _events(ds, idx):
    from repro_torch.core.events import Events

    return Events(edge_id=ds.ev_edge[idx], pos=ds.ev_pos[idx], time=ds.ev_time[idx])


def _feed_batches(ds, t_cut: float, tail_s: float, batches: int):
    """Indices of the tail's events, time-ordered, cut into ``batches``
    equal spans of time (an empty span gives no batch)."""
    tail = np.flatnonzero(ds.ev_time > t_cut)
    tail = tail[np.argsort(ds.ev_time[tail], kind="stable")]
    edges = t_cut + tail_s * np.arange(1, batches) / batches
    return [b for b in np.split(tail, np.searchsorted(ds.ev_time[tail], edges, "right"))
            if b.shape[0]]


def setup(*, cfg, params, ds, b_t, rng, device, spans, sync):
    from repro_torch.core import TNKDE

    s = closed_loop._Sut()
    s.params = params
    s.in_flight = int(params["in_flight"])
    s.cfg = cfg
    feed = cfg["feed"]
    t_cut = float(ds.ev_time.max()) - float(feed["tail_s"])
    hist = ds.ev_time <= t_cut
    with spans.span("build"):
        net, ev = network_and_events(dataclasses.replace(
            ds, ev_edge=ds.ev_edge[hist], ev_pos=ds.ev_pos[hist], ev_time=ds.ev_time[hist]))
        s.model = TNKDE(net, ev, table_codec=cfg["table_codec"], device=device,
                        **model_kwargs(cfg, b_t), **{k: cfg[k] for k in DRFS_KEYS})
    n_tail = int((~hist).sum())
    with spans.span("feed"):
        for idx in _feed_batches(ds, t_cut, float(feed["tail_s"]), int(feed["batches"])):
            s.model.insert(_events(ds, idx))
    index = s.model.index
    if index.n_pending != n_tail or index.n_sealed != int(hist.sum()):
        raise RuntimeError(f"feed of {n_tail} events left {index.n_pending} pending and "
                           f"{index.n_sealed} sealed of {int(hist.sum())}")
    s.sealed_edge = ds.ev_edge[hist]
    warm = closed_loop._centres(params, ds, np.random.default_rng(rng.integers(2**63)))
    s.next_ts = closed_loop._centres(params, ds, rng) if params["centres"] == "uniform" else warm
    with spans.span("first_query"):
        s.model.query(warm(0))
        sync()
    pending = deque()
    for k in range(1, 1 + int(params["warm_queries"])):
        pending.append(s.model.dispatch(warm(k)))
        if len(pending) >= s.in_flight:
            pending.popleft().result()
    while pending:
        pending.popleft().result()
    s.ds = ds
    return s


def _scanned(stats) -> int:
    return stats.n_partial_scanned + stats.n_pending_scanned


def measure(s, **kw):
    pairs0 = _scanned(s.model.stats)
    out = closed_loop.measure(s, **kw)
    out["counters"]["scan_pairs"] = _scanned(s.model.stats) - pairs0
    return out


def work(s, out):
    """The tree phase's roofline account (``harness.roofline_drfs``; every
    query of the cell does the same tree work) times the traced window's
    queries."""
    per = roofline_drfs.query_work(s.ds, s.cfg, int(s.params["windows"]), s.sealed_edge)
    return {"drfs_walk": {q: v * out["n_queries"] for q, v in per.items()}}


def release(s):
    s.model = None
