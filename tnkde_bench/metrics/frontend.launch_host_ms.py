"""Front end: host time of the per-pack loop of
``FlatForestEngine.flush_plan`` a query, from the port's ``tnkde.launch``
span: every atom pack's ``fused_walk`` and ``segment_add`` launches.
Milliseconds a query; moves ``query_p95_ms``."""

from tnkde_bench.harness.program_spans import query_ms, records


def read(run):
    return query_ms(records(), "tnkde.launch")
