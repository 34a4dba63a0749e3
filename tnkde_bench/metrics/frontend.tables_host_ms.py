"""Front end: host time of ``FlatForestEngine.window_tables`` a query, from
the port's ``tnkde.tables`` span: on a fresh ``ts`` tuple the enqueue of the
window-table fold (``torch_engine.packed_node_tables``, thousands of plain
torch ops). Milliseconds a query; moves ``query_p95_ms``."""

from tnkde_bench.harness.program_spans import query_ms, records


def read(run):
    return query_ms(records(), "tnkde.tables")
