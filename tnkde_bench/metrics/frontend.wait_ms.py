"""Front end: host time blocked on the card in ``PendingQuery.result`` a
query, from the port's ``tnkde.wait`` span (the one device-to-host
transfer, which waits for everything enqueued before it). Milliseconds a
query; moves ``windows_per_s``."""

from tnkde_bench.harness.program_spans import query_ms, records


def read(run):
    return query_ms(records(), "tnkde.wait")
