"""Open-loop load generation, frozen from the port's ``serve/loadgen.py``.

The drive loop is ``run_open_loop``'s as it stood when the benchmark was
defined: every arrival that is due is admitted before any serving work, full
flushes are pumped at once, a partial flush is forced when its oldest
request has lingered ``linger_s``, and a request's latency runs from its
SCHEDULED arrival to its response, so a stall is priced into every request
behind it (no coordinated omission).

Two changes keep runs of different seeds doing the same work: a window of
``seconds`` at ``rate_hz`` holds exactly ``round(rate_hz * seconds)``
arrivals whose gaps are one fixed set, the exponential distribution's
quantiles at the midpoints of n equal slices (a Poisson process's gaps), in
an order drawn from the seed; and request widths are a fixed multiset
(1..max_windows centres in equal shares) in an order drawn from the seed. Centres are
uniform over the event span, as in ``make_request_mix``, without inserts.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["arrivals", "request_mix", "drive"]


def arrivals(rate_hz: float, seconds: float, rng) -> np.ndarray:
    """Offsets (s) of the window's arrivals: round(rate x seconds) of them,
    the first at 0, the gaps exponential quantiles in a seeded order,
    scaled to fill the window."""
    n = max(int(round(float(rate_hz) * float(seconds))), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng.shuffle(gaps)
    return float(seconds) * (np.cumsum(gaps) - gaps[0]) / gaps.sum()


def request_mix(n: int, t_lo: float, t_hi: float, max_windows: int, rng):
    """n requests of 1..max_windows centres each (equal shares, seeded order),
    centres uniform over [t_lo, t_hi)."""
    widths = np.resize(np.arange(1, max_windows + 1), n)
    rng.shuffle(widths)
    return [tuple(float(t) for t in rng.uniform(t_lo, t_hi, int(w))) for w in widths]


def drive(server, requests, offsets, *, profile: str, spans, on_response,
          linger_s: float = 0.005, drain_s: float = 60.0, sleep_fn=time.sleep):
    """Admit ``requests[i]`` at ``t0 + offsets[i]`` and serve them; calls
    ``on_response(i, response, latency_s)`` for each answer. Returns
    (t0, t_end, shed, late_s): the start, when the last answer came, the
    requests refused at admission, and how late admission ran behind the
    schedule at the most. Requests still unanswered ``drain_s`` after the
    last arrival are left unanswered."""
    from repro_torch.serve.errors import ServeRejected

    n = len(requests)
    shed = 0
    late = 0.0
    t0 = time.perf_counter()
    t_end = t0
    stop = t0 + float(offsets[-1]) + drain_s

    def handle(responses):
        nonlocal t_end
        t = time.perf_counter()
        for r in responses:
            on_response(r.tag, r, t - (t0 + offsets[r.tag]))
        if responses:
            t_end = t

    i = 0
    while i < n or server.n_queued:
        now = time.perf_counter()
        if now > stop:
            break
        with spans.span("admit"):
            while i < n and t0 + offsets[i] <= now:
                late = max(late, now - (t0 + offsets[i]))
                try:
                    server.submit(requests[i], profile=profile, tag=i)
                except ServeRejected:
                    shed += 1
                i += 1
        if server.has_ready_batch:
            with spans.span("pump"):
                handle(server.pump(force=False))
            continue
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            lingered = oldest is not None and time.perf_counter() - oldest >= linger_s
            if i >= n or lingered:
                with spans.span("pump"):
                    handle(server.pump(force=True))
                continue
        waits = []
        if i < n:
            waits.append(t0 + offsets[i] - time.perf_counter())
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            if oldest is not None:
                waits.append(linger_s - (time.perf_counter() - oldest))
        dt = min(waits) if waits else 0.0
        if dt > 0:
            sleep_fn(min(dt, 0.01))
    return t0, t_end, shed, late
