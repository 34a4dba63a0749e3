"""The first query: host plan (``query_plan.build_host_plan``), the first
window tables and atom packs, and the kernels' libraries loaded; the span
around the first query, or around ``TNKDEServer.warmup()``. Seconds; moves
``setup_s``."""


def read(run):
    t = run.spans.total("first_query")
    return t if run.spans.times.get("first_query") else None
