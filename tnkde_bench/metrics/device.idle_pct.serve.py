"""Device idle share over the traced window of a served cell, as
``device.idle_pct``. Percent; moves ``request_p95_ms``."""


def read(run):
    if run.device is None or run.device.window_s <= 0.0:
        return None
    return (1.0 - run.device.busy_s / run.device.window_s) * 100.0
