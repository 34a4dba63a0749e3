"""Scheduler above capacity: ``serve.wait_ms``'s reading (``tnkde.wait``
under ``serve.retire`` an engine flush). Milliseconds; moves
``windows_per_s``."""

from tnkde_bench.harness.program_spans import flush_wait_ms, records


def read(run):
    return flush_wait_ms(records())
