"""Scheduler above capacity: the 95th percentile of every request's latency
in the traced window, from its scheduled arrival to its response. The
queue grows all through such a run, so this tail swings with the smallest
change and is no end-to-end metric there. Milliseconds; moves
``windows_per_s``."""

import numpy as np


def read(run):
    lat = run.serve.get("latencies_s")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, 95)) * 1e3
