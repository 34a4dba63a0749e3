"""Scheduler (``serve/continuous.py``): window centres a flush carries, as
the server's stats count them (``n_windows_evaluated`` over ``n_flushes``,
padding to the window class included), over the traced window. Moves
``request_p95_ms``."""


def read(run):
    f = run.serve.get("flushes")
    if not f:
        return None
    return run.serve["windows_evaluated"] / f
