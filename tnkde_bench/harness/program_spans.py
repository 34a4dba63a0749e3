"""The port's own host spans (``repro_torch.obs``), as the per-layer metric
readers of a ``--trace 1`` run see them.

The port records a span while a profiler records, so the records are those
of the traced window. A checkout of the port without the recorder, or a
window that recorded nothing, gives ``None``: the reader's metric is left
out. Records are read by field name only (``id``, ``parent``, ``name``,
``t0_ns``, ``t1_ns``, ``attrs``).

* "A query" is one ``tnkde.dispatch`` record.
* "An engine flush" is one ``serve.dispatch`` record whose flush sent
  centres to the engine (``misses`` > 0).
"""
from __future__ import annotations

__all__ = ["records", "query_ms", "dispatch_self_ms", "flush_dispatch_ms", "flush_wait_ms"]


def records():
    """The traced window's records, or ``None``."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.records() or None


def _ns(r) -> int:
    return r.t1_ns - r.t0_ns


def _named(recs, name):
    return [r for r in recs if r.name == name]


def query_ms(recs, name):
    """Milliseconds a query of the records named ``name``."""
    if not recs:
        return None
    n = len(_named(recs, "tnkde.dispatch"))
    hits = _named(recs, name)
    if not n or not hits:
        return None
    return sum(map(_ns, hits)) / n * 1e-6


def dispatch_self_ms(recs):
    """Milliseconds a query of ``tnkde.dispatch`` less its ``tnkde.tables``
    and ``tnkde.launch`` children: the plan and pack lookups, the window
    batch with its uploads, the heatmap."""
    if not recs:
        return None
    queries = _named(recs, "tnkde.dispatch")
    if not queries:
        return None
    ids = {r.id for r in queries}
    kids = [r for r in recs
            if r.parent in ids and r.name in ("tnkde.tables", "tnkde.launch")]
    return (sum(map(_ns, queries)) - sum(map(_ns, kids))) / len(queries) * 1e-6


def _engine_flushes(recs):
    return [r for r in recs if r.name == "serve.dispatch" and r.attrs.get("misses", 0) > 0]


def flush_dispatch_ms(recs):
    """Milliseconds of ``serve.dispatch`` an engine flush."""
    flushes = _engine_flushes(recs or ())
    if not flushes:
        return None
    return sum(map(_ns, flushes)) / len(flushes) * 1e-6


def flush_wait_ms(recs):
    """Milliseconds of ``tnkde.wait`` under ``serve.retire`` an engine flush:
    the serving loop blocked on the card."""
    flushes = _engine_flushes(recs or ())
    if not flushes:
        return None
    by_id = {r.id: r for r in recs}

    def under_retire(r):
        while r.parent is not None and r.parent in by_id:
            r = by_id[r.parent]
            if r.name == "serve.retire":
                return True
        return False

    waits = [r for r in _named(recs, "tnkde.wait") if under_retire(r)]
    if not waits:
        return None
    return sum(map(_ns, waits)) / len(flushes) * 1e-6
