"""Scheduler: the mean of ``Response.stats.queue_seconds`` (admission to the
flush's dispatch) over the traced window's answers. Milliseconds; moves
``request_p95_ms``."""


def read(run):
    q = run.serve.get("queue_s")
    if not q:
        return None
    return sum(q) / len(q) * 1e3
