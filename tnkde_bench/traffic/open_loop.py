"""Open-loop traffic: independent dashboard users behind the serve tier
(``TNKDEServer.submit`` / ``pump``), arriving on a schedule whatever the
server does.

Parameters (the cell's ``params``):

* ``rate_hz``: requests offered a second; a window of ``seconds`` holds
  exactly round(rate_hz x seconds) arrivals (``harness.loadgen``);
* ``max_windows``: a request asks 1..max_windows centres, uniform over the
  event span;
* ``linger_s``: how long a partial flush may wait for company;
* ``profile``: the server's profile name.

Set-up builds the server, runs its ``warmup()`` and one flush of every
window class the scheduler can form, so the window builds nothing. A
request's latency runs from its scheduled arrival to its response; one that
is refused, fails or never comes counts as missing (infinite).
"""
from __future__ import annotations

import numpy as np

from tnkde_bench.harness import loadgen
from tnkde_bench.harness.program import build_server


class _Sut:
    pass


def setup(*, cfg, params, ds, b_t, rng, device, spans, sync):
    from repro_torch.serve import window_class

    s = _Sut()
    s.params = params
    s.profile = params["profile"]
    with spans.span("build"):
        s.server = build_server(cfg, ds, b_t, device, s.profile)
    with spans.span("first_query"):
        s.server.warmup()
        sync()
    cap = s.server.window_cap
    model = s.server.models[s.profile]
    t_lo, t_hi = ds.t_min, ds.t_min + ds.t_span
    for wc in sorted({window_class(n, cap) for n in range(1, cap + 1)}):
        model.query([float(t) for t in rng.uniform(t_lo, t_hi, wc)])
    sync()
    s.offsets_rng = np.random.default_rng(rng.integers(2**63))
    s.mix_rng = np.random.default_rng(rng.integers(2**63))
    s.t_lo, s.t_hi = t_lo, t_hi
    return s


def measure(s, *, seconds, spans, sync, answers):
    p = s.params
    offsets = loadgen.arrivals(float(p["rate_hz"]), seconds, s.offsets_rng)
    requests = loadgen.request_mix(len(offsets), s.t_lo, s.t_hi, int(p["max_windows"]),
                                   s.mix_rng)
    server = s.server
    st = server.stats
    flushes0, evaluated0 = st.n_flushes, st.n_windows_evaluated
    lat = np.full(len(requests), np.inf)
    queue_s = []
    windows = 0

    def on_response(i, r, latency):
        nonlocal windows
        if not r.ok:
            return
        lat[i] = latency
        queue_s.append(r.stats.queue_seconds)
        answers.keep(i, requests[i], r.heat)
        windows += len(requests[i])

    t0, t_end, shed, late = loadgen.drive(server, requests, offsets, profile=s.profile,
                                          spans=spans, on_response=on_response,
                                          linger_s=float(p["linger_s"]))
    answered = int(np.isfinite(lat).sum())
    window_s = max(t_end - t0, 1e-9)
    return dict(
        attempted=len(requests), failed=len(requests) - answered,
        n_queries=st.n_flushes - flushes0, window_s=window_s, answers=answers,
        late_s=late, t_after_close_s=t_end - t0 - seconds,
        serve={"flushes": st.n_flushes - flushes0,
               "windows_evaluated": st.n_windows_evaluated - evaluated0,
               "queue_s": queue_s, "shed": shed, "latencies_s": lat},
        e2e={"windows_per_s": (windows / window_s, "windows/s"),
             "request_p95_ms": (float(np.percentile(lat, 95)) * 1e3, "ms")})


def release(s):
    s.server = None
