"""Streaming scans: (atom, event) pairs the scans examined a query (the
traffic module's ``scan_pairs`` counter over the window: ``QueryStats``
``n_partial_scanned + n_pending_scanned``, per half-window for the
boundary leaves and per window for the pending events). Moves
``windows_per_s``."""


def read(run):
    n = run.counters.get("scan_pairs")
    if n is None or not run.n_queries:
        return None
    return n / run.n_queries
