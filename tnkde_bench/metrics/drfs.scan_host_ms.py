"""Streaming scans: host time of the scan phases a query, from the port's
``tnkde.scan`` spans (one a block, under ``tnkde.launch``: the boundary-leaf
scan and the pending scan of ``torch_engine.eval_atoms_dyn``, plain torch,
one masked trip at a time). Milliseconds a query; moves ``windows_per_s``."""

from tnkde_bench.harness.program_spans import query_ms, records


def read(run):
    return query_ms(records(), "tnkde.scan")
