"""Scheduler: host time the serving loop is blocked on the card an engine
flush, from the port's ``tnkde.wait`` spans under ``serve.retire``.
Milliseconds an engine flush; moves ``request_p95_ms``."""

from tnkde_bench.harness.program_spans import flush_wait_ms, records


def read(run):
    return flush_wait_ms(records())
