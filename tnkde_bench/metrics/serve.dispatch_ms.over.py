"""Scheduler above capacity: ``serve.dispatch_ms``'s reading (host time of
``serve.dispatch`` an engine flush). Milliseconds; moves
``windows_per_s``."""

from tnkde_bench.harness.program_spans import flush_dispatch_ms, records


def read(run):
    return flush_dispatch_ms(records())
