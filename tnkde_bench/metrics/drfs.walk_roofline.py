"""``fused_walk`` on the streaming index's exact tree phase
(``ops.fused_walk_flat`` -> ``csrc/fused_walk.cu`` over the complete tree):
the least time one H100 needs for the tree phase of the traced window's
queries (``harness.roofline_drfs``: the distinct node rows of the covered
leaf ranges' canonical decompositions, read once, the atoms' coefficients,
their outputs written once; 3.35 TB/s, f64 34 TFLOP/s), over the
profiler's device time of the kernel in that window. Percent; moves
``windows_per_s``."""

from tnkde_bench.harness import roofline


def read(run):
    if run.device is None or "drfs_walk" not in run.work:
        return None
    t = run.device.kernel_seconds("fused_walk_kernel")
    if t <= 0.0:
        return None
    return roofline.bound_seconds(run.work["drfs_walk"]) / t * 100.0
