"""Closed-loop traffic: one analyst's client keeping ``in_flight`` queries
of ``windows`` centres each in flight through ``TNKDE.dispatch`` /
``PendingQuery.result`` (the next frame is dispatched before the oldest one
is read).

Parameters (the cell's ``params``):

* ``windows``: centres per query;
* ``in_flight``: queries dispatched and not yet read;
* ``centres``: ``"uniform"`` draws every query's centres anew, uniformly
  over the event span (no tuple repeats: every query rebuilds its window
  tables); ``"panels"`` alternates between fixed tuples, one per entry of
  ``panel_steps_s``, each ``windows`` centres that step apart from a start
  drawn uniformly where the tuple fits in the span;
* ``warm_queries``: queries of the same kind run in set-up after the first.

A query's latency runs from its ``dispatch`` call to the return of its
``result``; the rate counts the windows of every query dispatched in the
window, over the time until the last of them is read.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from tnkde_bench.harness import roofline
from tnkde_bench.harness.program import build_model


class _Sut:
    pass


def _centres(params, ds, rng):
    """next(k) -> the k-th query's tuple of centres."""
    W = int(params["windows"])
    t_lo, t_hi = ds.t_min, ds.t_min + ds.t_span
    if params["centres"] == "uniform":
        return lambda k: tuple(float(t) for t in rng.uniform(t_lo, t_hi, W))
    panels = []
    for step in params["panel_steps_s"]:
        start = rng.uniform(t_lo, t_hi - (W - 1) * float(step))
        panels.append(tuple(float(start + i * float(step)) for i in range(W)))
    return lambda k: panels[k % len(panels)]


def setup(*, cfg, params, ds, b_t, rng, device, spans, sync):
    s = _Sut()
    s.params = params
    s.in_flight = int(params["in_flight"])
    s.cfg = cfg
    with spans.span("build"):
        s.model = build_model(cfg, ds, b_t, device)
    warm = _centres(params, ds, np.random.default_rng(rng.integers(2**63)))
    s.next_ts = _centres(params, ds, rng) if params["centres"] == "uniform" else warm
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


def measure(s, *, seconds, spans, sync, answers):
    model = s.model
    L = model.n_lixels
    W = int(s.params["windows"])
    lat, pending = [], deque()
    windows = failed = k = 0
    searches0 = model.stats.n_rank_searches

    def retire():
        nonlocal windows, failed
        key, ts, t_d, p = pending.popleft()
        with spans.span("result"):
            F = p.result()
        lat.append(time.perf_counter() - t_d)
        answers.keep(key, ts, F)
        if F.shape == (W, L):
            windows += W
        else:
            failed += 1

    t0 = time.perf_counter()
    stop = t0 + seconds
    while time.perf_counter() < stop:
        ts = s.next_ts(k)
        t_d = time.perf_counter()
        with spans.span("dispatch"):
            p = model.dispatch(ts)
        pending.append((k, ts, t_d, p))
        k += 1
        if len(pending) >= s.in_flight:
            retire()
    while pending:
        retire()
    t_end = time.perf_counter()
    return dict(
        attempted=k, failed=failed, n_queries=k, window_s=t_end - t0, answers=answers,
        counters={"rank_searches": model.stats.n_rank_searches - searches0},
        e2e={"windows_per_s": (windows / (t_end - t0), "windows/s"),
             "query_p95_ms": (float(np.percentile(lat, 95)) * 1e3, "ms")})


def work(s, out):
    """Roofline accounts of the traced window: the query's work, derived from
    the benchmark's own network and events (``harness.roofline``; every query
    of the cell does the same work), times the queries."""
    per = roofline.query_work(s.ds, s.cfg, int(s.params["windows"]))
    n = out["n_queries"]
    return {k: {q: v * n for q, v in acc.items()} for k, acc in per.items()}


def release(s):
    s.model = None
