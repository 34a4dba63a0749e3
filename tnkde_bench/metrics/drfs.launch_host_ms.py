"""Front end of the streaming index: host time of the block loop of
``FlatDynamicEngine.flush_plan`` a query, less its scan phases: the port's
``tnkde.launch`` spans less their ``tnkde.scan`` children (the scan work's
accounting, each block's ``fused_walk`` and ``segment_add`` launches).
Milliseconds a query; moves ``windows_per_s``."""

from tnkde_bench.harness.program_spans import records


def read(run):
    recs = records()
    if not recs:
        return None
    n = sum(r.name == "tnkde.dispatch" for r in recs)
    launches = {r.id: r for r in recs if r.name == "tnkde.launch"}
    if not n or not launches:
        return None
    ns = sum(r.t1_ns - r.t0_ns for r in launches.values())
    ns -= sum(r.t1_ns - r.t0_ns for r in recs
              if r.name == "tnkde.scan" and r.parent in launches)
    return ns / n * 1e-6
