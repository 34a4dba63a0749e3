"""Scheduler (``serve/continuous.py``) above capacity: window centres a
flush carries (``n_windows_evaluated`` over ``n_flushes``, padding to the
window class included), over the traced window. Moves ``windows_per_s``."""


def read(run):
    f = run.serve.get("flushes")
    if not f:
        return None
    return run.serve["windows_evaluated"] / f
