"""Device idle share over the traced window of a cell judged by its rate
(closed loop, or served above capacity): 1 - the union of kernel and copy
intervals over the window's length. Percent; moves ``windows_per_s``."""


def read(run):
    if run.device is None or run.device.window_s <= 0.0:
        return None
    return (1.0 - run.device.busy_s / run.device.window_s) * 100.0
