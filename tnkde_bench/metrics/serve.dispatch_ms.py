"""Scheduler: host time of ``ContinuousCore._dispatch_next`` an engine
flush, from the port's ``serve.dispatch`` span (from the popped group on:
the cache probe, then the model's whole dispatch with its window tables and
launches). Milliseconds an engine flush; moves ``request_p95_ms``."""

from tnkde_bench.harness.program_spans import flush_dispatch_ms, records


def read(run):
    return flush_dispatch_ms(records())
