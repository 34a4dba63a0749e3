"""``fused_walk`` (``ops.fused_walk_flat`` -> ``csrc/fused_walk.cu``): the
least time one H100 needs for the walk and window contraction of the traced
window's queries (``harness.roofline.walk_account``: the distinct window
table rows the decompositions need, read once, the atoms' coefficients,
their outputs written once; 3.35 TB/s, f64 34 TFLOP/s), over the profiler's
device time of the kernel in that window. Percent; moves ``windows_per_s``."""

from tnkde_bench.harness import roofline


def read(run):
    if run.device is None or "fused_walk" not in run.work:
        return None
    t = run.device.kernel_seconds("fused_walk_kernel")
    if t <= 0.0:
        return None
    return roofline.bound_seconds(run.work["fused_walk"]) / t * 100.0
