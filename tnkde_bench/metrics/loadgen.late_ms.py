"""The benchmark's load generator: how far admissions ran behind their
schedule, at the most, over the traced window. Milliseconds; moves
``request_p95_ms``."""


def read(run):
    return None if run.late_s is None else run.late_s * 1e3
