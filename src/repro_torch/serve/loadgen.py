"""Load generation + latency harness for the serving subsystem.

A **workload** is a list of :class:`QueryItem` / :class:`InsertItem` in
stream order — the same mix drives both drivers, so batched-vs-sequential
comparisons are apples to apples:

* :func:`run_sequential` — the pre-subsystem baseline: one engine pass per
  request against a bare ``TNKDE``, inserts applied inline (exactly the old
  ``launch.serve`` demo loop). Closed-loop: latency == service time.
* :func:`run_server` — drives a :class:`~repro_torch.serve.TNKDEServer`.
  ``rate_hz=None`` is the closed-loop saturation drain (every request
  already queued; the scheduler works at capacity). A finite ``rate_hz``
  replays a Poisson arrival process on the wall clock; the driver admits
  arrivals, pumps full batches immediately, and force-drains a partial
  batch only when the oldest queued request has lingered ``linger_s`` —
  the classic micro-batching cap + linger policy. Latency is completion
  minus *arrival*, so queueing delay is priced in.

Latency roll-ups (p50/p95/p99/mean, throughput) come from
:func:`summarize`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.events import Events

__all__ = [
    "QueryItem",
    "InsertItem",
    "LoadReport",
    "make_arrivals",
    "make_request_mix",
    "summarize",
    "run_sequential",
    "run_server",
    "run_open_loop",
]


@dataclasses.dataclass
class QueryItem:
    ts: Sequence[float]
    profile: str = "default"
    lixels: Optional[np.ndarray] = None


@dataclasses.dataclass
class InsertItem:
    events: Events


WorkItem = Union[QueryItem, InsertItem]


def make_request_mix(stream: Events, t_lo: float, t_hi: float, *,
                     n_requests: int, stream_every: int, max_windows: int = 2,
                     seed: int = 0) -> List["WorkItem"]:
    """A stream-ordered serving mix: 1..max_windows-center query items with
    an insert of the next stream slice every ``stream_every`` requests —
    the workload shape of ``repro_torch.launch.serve``; with the same seed
    it equals the reference package's mix item for item."""
    rng = np.random.default_rng(seed)
    n_inserts = max(n_requests // max(stream_every, 1), 1)
    per = max(stream.n // n_inserts, 1)
    items: List[WorkItem] = []
    s_off = 0
    for r in range(n_requests):
        w = int(rng.integers(1, max_windows + 1))
        items.append(QueryItem(ts=[float(t) for t in rng.uniform(t_lo, t_hi, w)]))
        if (r + 1) % stream_every == 0 and s_off < stream.n:
            hi = min(s_off + per, stream.n)
            items.append(InsertItem(Events(
                stream.edge_id[s_off:hi], stream.pos[s_off:hi], stream.time[s_off:hi]
            )))
            s_off = hi
    return items


def make_arrivals(n: int, rate_hz: Optional[float], seed: int = 0) -> np.ndarray:
    """Poisson arrival offsets (seconds) for n items; zeros when saturated."""
    if rate_hz is None or not np.isfinite(rate_hz):
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / float(rate_hz), size=n))


def summarize(latencies: np.ndarray, wall_seconds: float) -> dict:
    lat = np.asarray(latencies, np.float64)
    if lat.size == 0:
        return dict(n=0, wall_seconds=round(wall_seconds, 4), throughput_rps=0.0)
    q = lambda p: float(np.percentile(lat, p) * 1e3)  # noqa: E731
    return dict(
        n=int(lat.size),
        wall_seconds=round(float(wall_seconds), 4),
        throughput_rps=round(float(lat.size / max(wall_seconds, 1e-9)), 3),
        p50_ms=round(q(50), 3),
        p95_ms=round(q(95), 3),
        p99_ms=round(q(99), 3),
        mean_ms=round(float(lat.mean() * 1e3), 3),
        max_ms=round(float(lat.max() * 1e3), 3),
    )


@dataclasses.dataclass
class LoadReport:
    latencies: np.ndarray  # one entry per ANSWERED QueryItem, workload order
    wall_seconds: float
    n_shed: int = 0  # admissions rejected (QueueFull load shedding)
    n_errors: int = 0  # ok=False responses (deadline expiry, engine faults)
    rate_hz: Optional[float] = None  # offered rate (None = saturated drain)
    # fleet fault tolerance (router runs only; 0 against a single server).
    # The accounting invariant survives replica kills: every QueryItem is a
    # latency sample, an n_errors count, or an n_shed count — failovers and
    # hedges move/duplicate work but never add or drop a client answer.
    n_failovers: int = 0  # requests re-submitted after a replica fault
    n_hedges: int = 0  # duplicates placed against slow replicas
    n_hedge_wins: int = 0  # hedged duplicates that answered first

    def summary(self) -> dict:
        out = summarize(self.latencies, self.wall_seconds)
        out["n_shed"] = int(self.n_shed)
        out["n_errors"] = int(self.n_errors)
        if self.rate_hz is not None:
            out["offered_rate_hz"] = round(float(self.rate_hz), 3)
        if self.n_failovers or self.n_hedges:
            out["n_failovers"] = int(self.n_failovers)
            out["n_hedges"] = int(self.n_hedges)
            out["n_hedge_wins"] = int(self.n_hedge_wins)
        return out


def _ft_counters(server) -> tuple:
    """Cumulative (failovers, hedges, hedge_wins) on a router; zeros on a
    plain server. Drivers report the delta across their own run."""
    return (
        getattr(server, "n_failovers", 0),
        getattr(server, "n_hedges", 0),
        getattr(server, "n_hedge_wins", 0),
    )


def run_sequential(model, workload: List[WorkItem]) -> LoadReport:
    """Baseline: evaluate each request on its own, inserts inline."""
    lat: List[float] = []
    t_wall = time.perf_counter()
    for item in workload:
        if isinstance(item, InsertItem):
            model.insert(item.events)
            continue
        t0 = time.perf_counter()
        model.query(list(item.ts))
        lat.append(time.perf_counter() - t0)
    return LoadReport(np.asarray(lat), time.perf_counter() - t_wall)


def run_server(
    server,
    workload: List[WorkItem],
    *,
    rate_hz: Optional[float] = None,
    linger_s: float = 0.005,
    seed: int = 0,
    sleep_fn=time.sleep,
) -> LoadReport:
    """Drive the server with the workload; see module docstring for policy."""
    from .errors import ServeRejected

    n = len(workload)
    arrivals = make_arrivals(n, rate_hz, seed=seed)
    lat: dict = {}
    n_shed = 0
    n_errors = 0
    ft0 = _ft_counters(server)
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    def handle(responses):
        nonlocal n_errors
        t = now()
        for r in responses:
            if getattr(r, "ok", True):
                lat[r.tag] = t - arrivals[r.tag]
            else:
                n_errors += 1  # answered, but with a typed error — not a
                # latency sample (there is no completed result to time)

    i = 0
    while i < n or server.n_queued:
        t = now()
        while i < n and arrivals[i] <= t:
            item = workload[i]
            if isinstance(item, InsertItem):
                server.insert(item.events)
            else:
                try:
                    server.submit(
                        item.ts, profile=item.profile, lixels=item.lixels, tag=i
                    )
                except ServeRejected:
                    n_shed += 1  # load shed at admission: no response coming
            i += 1
            # serve a filled batch before admitting more — saturated mode
            # would otherwise admit the whole backlog first, fragmenting
            # epochs across every interleaved insert
            if server.has_ready_batch:
                handle(server.pump(force=False))
                t = now()
        if server.has_ready_batch:
            handle(server.pump(force=False))
            continue
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            lingered = oldest is not None and time.perf_counter() - oldest >= linger_s
            if i >= n or lingered:
                handle(server.pump(force=True))
                continue
        waits = []
        if i < n:
            waits.append(arrivals[i] - now())
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            if oldest is not None:
                waits.append(linger_s - (time.perf_counter() - oldest))
        dt = min(waits) if waits else 0.0
        if dt > 0:
            sleep_fn(min(dt, 0.01))
    wall = now()
    # only answered requests have samples: shed ones never got a Response,
    # errored ones got an ok=False Response and are counted, not timed
    out = np.asarray(
        [lat[j] for j in range(n) if isinstance(workload[j], QueryItem) and j in lat]
    )
    ft1 = _ft_counters(server)
    return LoadReport(
        out, wall, n_shed=n_shed, n_errors=n_errors, rate_hz=rate_hz,
        n_failovers=ft1[0] - ft0[0], n_hedges=ft1[1] - ft0[1],
        n_hedge_wins=ft1[2] - ft0[2],
    )


def run_open_loop(
    server,
    workload: List[WorkItem],
    *,
    rate_hz: float,
    linger_s: float = 0.005,
    seed: int = 0,
    sleep_fn=time.sleep,
) -> LoadReport:
    """Open-loop driver: the arrival process lives on the TRUE clock and
    never waits on the engine (no coordinated omission).

    Differences from :func:`run_server`'s finite-rate mode, which is what
    make overload measurements honest:

    * every arrival due *now* is admitted before any serving work — the
      driver never interleaves a pump between two due admissions, so a slow
      flush cannot silently thin the offered load;
    * latency is completion minus the request's **scheduled** arrival, so
      when the system falls behind, the time a request spends waiting to be
      admitted (and any admission lateness of the driver itself) is priced
      into p50/p99 instead of vanishing;
    * ``rate_hz`` must be finite — the saturated closed-loop drain is
      :func:`run_server`'s ``rate_hz=None`` mode.

    Works with any object exposing the server driving surface, including
    :class:`~repro_torch.serve.router.ReplicaRouter`.
    """
    from .errors import ServeRejected

    if rate_hz is None or not np.isfinite(rate_hz) or rate_hz <= 0:
        raise ValueError("run_open_loop needs a finite positive rate_hz "
                         "(saturation is run_server's rate_hz=None mode)")
    n = len(workload)
    arrivals = make_arrivals(n, rate_hz, seed=seed)
    lat: dict = {}
    n_shed = 0
    n_errors = 0
    ft0 = _ft_counters(server)
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    def handle(responses):
        nonlocal n_errors
        t = now()
        for r in responses:
            if getattr(r, "ok", True):
                lat[r.tag] = t - arrivals[r.tag]
            else:
                n_errors += 1

    i = 0
    while i < n or server.n_queued:
        t = now()
        while i < n and arrivals[i] <= t:
            item = workload[i]
            if isinstance(item, InsertItem):
                server.insert(item.events)
            else:
                try:
                    server.submit(
                        item.ts, profile=item.profile, lixels=item.lixels, tag=i
                    )
                except ServeRejected:
                    n_shed += 1
            i += 1
        if server.has_ready_batch:
            handle(server.pump(force=False))
            continue
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            lingered = oldest is not None and time.perf_counter() - oldest >= linger_s
            if i >= n or lingered:
                handle(server.pump(force=True))
                continue
        waits = []
        if i < n:
            waits.append(arrivals[i] - now())
        if server.n_queued:
            oldest = server.scheduler.oldest_arrival()
            if oldest is not None:
                waits.append(linger_s - (time.perf_counter() - oldest))
        dt = min(waits) if waits else 0.0
        if dt > 0:
            sleep_fn(min(dt, 0.01))
    ft1 = _ft_counters(server)
    return LoadReport(
        np.asarray([lat[j] for j in range(n)
                    if isinstance(workload[j], QueryItem) and j in lat]),
        now(), n_shed=n_shed, n_errors=n_errors, rate_hz=rate_hz,
        n_failovers=ft1[0] - ft0[0], n_hedges=ft1[1] - ft0[1],
        n_hedge_wins=ft1[2] - ft0[2],
    )
