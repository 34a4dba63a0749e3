"""Front end of the streaming index: host time of
``FlatDynamicEngine.window_tables`` a query, from the port's ``tnkde.tables``
span: on a fresh ``ts`` tuple the enqueue of the exact node-table fold
(``torch_engine.dyn_node_tables``, plain torch, ``fold_tables.FOLD_CHUNK``
nodes a chunk). Milliseconds a query; moves ``windows_per_s``."""

from tnkde_bench.harness.program_spans import query_ms, records


def read(run):
    return query_ms(records(), "tnkde.tables")
