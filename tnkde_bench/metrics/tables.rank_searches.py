"""Window tables: time-boundary searches a query (``TNKDE.stats``
``n_rank_searches``, the engine's ``rank_searches`` counter): 3 x W x the
forest's nodes when a query's tables are built, 0 when they come from the
cache. Moves ``windows_per_s``."""


def read(run):
    n = run.counters.get("rank_searches")
    if n is None or not run.n_queries:
        return None
    return n / run.n_queries
