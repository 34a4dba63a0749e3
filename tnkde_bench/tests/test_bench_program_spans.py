"""The readers of the port's own spans (``harness/program_spans.py`` and the
``metrics/`` files over it) on synthetic records: what each reads, that a
flush with no engine pass is not counted, and ``None`` (the metric left
out) where the port has no recorder or the window recorded nothing."""
import sys
from typing import NamedTuple, Optional

import pytest

from tnkde_bench.harness import cell as C
from tnkde_bench.harness import program_spans as P

MS = 1_000_000


class Rec(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


def _query(ids, t, *, tables, launch, plan=1, wait=2):
    """One query's records from ``t`` ms: dispatch ⊃ plan, window_batch,
    tables, packs, launch; result ⊃ wait. Returns (records, next t)."""
    d, r = next(ids), next(ids)
    out, at = [], t
    for name, ms in (("tnkde.plan", plan), ("tnkde.window_batch", 1),
                     ("tnkde.tables", tables), ("tnkde.packs", 1), ("tnkde.launch", launch)):
        out.append(Rec(next(ids), d, name, at * MS, (at + ms) * MS, {}))
        at += ms
    out.append(Rec(d, None, "tnkde.dispatch", t * MS, (at + 3) * MS, {"query": d}))
    out.append(Rec(next(ids), r, "tnkde.wait", (at + 3) * MS, (at + 3 + wait) * MS, {}))
    out.append(Rec(r, None, "tnkde.result", (at + 3) * MS, (at + 4 + wait) * MS, {"query": d}))
    return out, at + 5 + wait


def _fresh():
    ids = iter(range(1, 1000))
    a, t = _query(ids, 0, tables=40, launch=20)
    b, _ = _query(ids, t, tables=60, launch=30, wait=4)
    return a + b


def _flush(ids, t, *, misses, dispatch, wait):
    sd, sr = next(ids), next(ids)
    out = [Rec(sd, None, "serve.dispatch", t * MS, (t + dispatch) * MS,
               {"flush": sd, "requests": [1], "misses": misses})]
    if misses:
        q, t_end = _query(ids, t, tables=dispatch // 2, launch=1, wait=wait)
        for r in q:
            parent = r.parent if r.parent is not None else (sd if r.name == "tnkde.dispatch"
                                                             else sr)
            out.append(r._replace(parent=parent))
    out.append(Rec(sr, None, "serve.retire", (t + dispatch) * MS, (t + dispatch + wait) * MS,
                   {"flush": sd}))
    return out


def _served():
    ids = iter(range(1, 1000))
    return (_flush(ids, 0, misses=3, dispatch=60, wait=10)
            + _flush(ids, 100, misses=0, dispatch=2, wait=0)  # rows from the cache
            + _flush(ids, 200, misses=5, dispatch=80, wait=6))


def test_front_end_readings():
    recs = _fresh()
    assert P.query_ms(recs, "tnkde.tables") == pytest.approx(50.0)
    assert P.query_ms(recs, "tnkde.launch") == pytest.approx(25.0)
    assert P.query_ms(recs, "tnkde.wait") == pytest.approx(3.0)
    # dispatch less tables and launch: plan 1, window batch 1, packs 1, the rest 3
    assert P.dispatch_self_ms(recs) == pytest.approx(6.0)
    whole = P.query_ms(recs, "tnkde.dispatch")
    parts = (P.query_ms(recs, "tnkde.tables") + P.query_ms(recs, "tnkde.launch")
             + P.dispatch_self_ms(recs))
    assert whole == pytest.approx(parts)


def test_served_readings_count_engine_flushes_only():
    recs = _served()
    assert P.flush_dispatch_ms(recs) == pytest.approx(70.0)
    assert P.flush_wait_ms(recs) == pytest.approx(8.0)
    # a wait outside any retire (a query the loop made itself) is not the loop's
    stray = Rec(999, None, "tnkde.wait", 0, 50 * MS, {})
    assert P.flush_wait_ms(recs + [stray]) == pytest.approx(8.0)


@pytest.mark.parametrize("recs", [None, [], "no_match"])
def test_nothing_to_read_leaves_the_metric_out(recs):
    if recs == "no_match":
        recs = [Rec(1, None, "other", 0, MS, {})]
    assert P.query_ms(recs, "tnkde.tables") is None
    assert P.dispatch_self_ms(recs) is None
    assert P.flush_dispatch_ms(recs) is None
    assert P.flush_wait_ms(recs) is None


def _reader(name):
    return C.load_module(C.BENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name,kind,want", [
    ("frontend.tables_host_ms", "fresh", 50.0),
    ("frontend.launch_host_ms", "fresh", 25.0),
    ("frontend.dispatch_self_ms", "fresh", 6.0),
    ("frontend.wait_ms", "fresh", 3.0),
    ("serve.dispatch_ms", "served", 70.0),
    ("serve.wait_ms", "served", 8.0),
    ("serve.dispatch_ms.over", "served", 70.0),
    ("serve.wait_ms.over", "served", 8.0),
])
def test_metric_files_read_the_port_recorder(monkeypatch, name, kind, want):
    from repro_torch import obs

    recs = _fresh() if kind == "fresh" else _served()
    monkeypatch.setattr(obs, "records", lambda: list(recs))
    assert _reader(name).read(None) == pytest.approx(want)
    monkeypatch.setattr(obs, "records", lambda: [])
    assert _reader(name).read(None) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # a port without it
    assert _reader(name).read(None) is None
