"""Front end: host time of ``TNKDE.dispatch`` a query less its window tables
and its launches (``tnkde.dispatch`` minus its ``tnkde.tables`` and
``tnkde.launch`` children): the plan and pack lookups, the window batch
with its uploads, the heatmap. With ``frontend.tables_host_ms`` and
``frontend.launch_host_ms`` it makes the whole dispatch. Milliseconds a
query; moves ``query_p95_ms``."""

from tnkde_bench.harness.program_spans import dispatch_self_ms, records


def read(run):
    return dispatch_self_ms(records())
