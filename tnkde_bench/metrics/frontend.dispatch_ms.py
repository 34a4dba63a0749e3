"""Front end: host time inside ``TNKDE.dispatch`` (plan-cache lookup, window
batch, window tables and flushes enqueued), from the benchmark's spans,
over the traced window divided by the queries. Milliseconds a query; moves
``query_p95_ms``."""


def read(run):
    d = run.spans.times.get("dispatch")
    if not d or not run.n_queries:
        return None
    return sum(d) / run.n_queries * 1e3
