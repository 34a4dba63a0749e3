"""``segment_add`` (``ops.segment_add`` -> ``csrc/segment_add.cu``): the least
time one H100 needs to add every atom's W values onto its lixel
(``harness.roofline.scatter_account``: rows read once, touched outputs
written once), over the profiler's device time of the kernel in the traced
window. Percent; moves ``windows_per_s``."""

from tnkde_bench.harness import roofline


def read(run):
    if run.device is None or "segment_add" not in run.work:
        return None
    t = run.device.kernel_seconds("segment_add_f64_kernel")
    if t <= 0.0:
        return None
    return roofline.bound_seconds(run.work["segment_add"]) / t * 100.0
