"""The port's write-ahead log (``repro_torch.core.wal``) against the
reference package's (``repro.core.wal``): the same operations write the
same bytes, a log written by either package is read by the other with equal
records, and a torn tail is truncated the same way whichever package tore
it and whichever reads it. Plus the reference's own unit properties on the
port: corruption before the tail raises, rotation + pruning, sequence
numbers that survive a reopen after rotate + prune.
"""
import os

import numpy as np
import pytest

import repro.core.wal as ref_wal
import repro.ft.faults as ref_faults
import repro_torch.core.wal as port_wal
import repro_torch.ft.faults as port_faults
from repro.core.events import Events as RefEvents
from repro_torch.core import WriteAheadLog
from repro_torch.core.events import Events
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PACKAGES = {"port": (port_wal, port_faults, Events), "ref": (ref_wal, ref_faults, RefEvents)}


def _batches(cls, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 0, 9):
        out.append(cls(rng.integers(0, 12, n).astype(np.int32), rng.uniform(0.0, 50.0, n),
                       np.sort(rng.uniform(0.0, 1e5, n))))
    return out


def _write(pkg, path):
    """insert, seal, insert (empty), extend, evict, insert — every kind."""
    wal, _, cls = PACKAGES[pkg]
    w = wal.WriteAheadLog(str(path))
    b = _batches(cls)
    w.append_insert(b[0])
    w.append_marker(wal.KIND_SEAL)
    w.append_insert(b[1])
    w.append_marker(wal.KIND_EXTEND)
    w.append_evict(123456.5)
    w.append_insert(b[2])
    w.close()
    return w


def _records(pkg, path):
    wal = PACKAGES[pkg][0]
    r = wal.WriteAheadLog(str(path))
    return r, list(r.records())


def _same_records(a, b):
    assert [(x.seq, x.kind, x.t_now) for x in a] == [(x.seq, x.kind, x.t_now) for x in b]
    for x, y in zip(a, b):
        assert (x.events is None) == (y.events is None)
        if x.events is not None:
            for f in ("edge_id", "pos", "time"):
                np.testing.assert_array_equal(getattr(x.events, f), getattr(y.events, f))


def _segment_bytes(path):
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))}


def test_both_packages_write_the_same_bytes(tmp_path):
    _write("port", tmp_path / "port")
    _write("ref", tmp_path / "ref")
    a, b = _segment_bytes(tmp_path / "port"), _segment_bytes(tmp_path / "ref")
    assert list(a) == ["seg_000000000001.wal"] and a == b


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_log_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    _write(writer, tmp_path)
    r, recs = _records(reader, tmp_path)
    _, own = _records(writer, tmp_path)
    assert [x.seq for x in recs] == [1, 2, 3, 4, 5, 6]
    assert r.last_seq == 6 and r.truncated_bytes == 0
    _same_records(recs, own)
    assert recs[4].kind == port_wal.KIND_EVICT and recs[4].t_now == 123456.5
    assert [x.seq for x in r.records(after_seq=3)] == [4, 5, 6]


@pytest.mark.parametrize("scribble", [False, True], ids=["truncate", "scribble"])
@pytest.mark.parametrize("tearer,reader", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_torn_tail_truncated_alike(tmp_path, tearer, reader, scribble):
    """Tear the last record with one package's ``tear_wal_tail``; opening
    with either package truncates the same bytes and keeps the same
    records, and the repaired log appends at the next sequence number."""
    _write(tearer, tmp_path / "a")
    _write(tearer, tmp_path / "b")
    PACKAGES[tearer][1].tear_wal_tail(str(tmp_path / "a"), nbytes=7, scribble=scribble)
    PACKAGES[tearer][1].tear_wal_tail(str(tmp_path / "b"), nbytes=7, scribble=scribble)
    ra, recs_a = _records(reader, tmp_path / "a")
    rb, recs_b = _records("ref" if reader == "port" else "port", tmp_path / "b")
    assert ra.truncated_bytes == rb.truncated_bytes > 0
    assert [x.seq for x in recs_a] == [1, 2, 3, 4, 5]
    _same_records(recs_a, recs_b)
    assert _segment_bytes(tmp_path / "a") == _segment_bytes(tmp_path / "b")
    assert ra.append_marker(port_wal.KIND_SEAL) == 6


def test_damage_before_tail_raises(tmp_path):
    w = WriteAheadLog(str(tmp_path))
    for b in _batches(Events):
        w.append_insert(b)
    w.rotate()
    w.append_marker(port_wal.KIND_SEAL)
    w.close()
    first = tmp_path / sorted(os.listdir(tmp_path))[0]
    raw = bytearray(first.read_bytes())
    raw[30] ^= 0xFF  # inside the first record's payload
    first.write_bytes(bytes(raw))
    with pytest.raises(port_wal.WalError):
        WriteAheadLog(str(tmp_path))


def test_marker_kind_validated(tmp_path):
    w = WriteAheadLog(str(tmp_path))
    for kind in (port_wal.KIND_INSERT, port_wal.KIND_EVICT):
        with pytest.raises(ValueError):
            w.append_marker(kind)


def test_rotate_prune_and_reopen_keep_the_sequence(tmp_path):
    w = WriteAheadLog(str(tmp_path))
    b = _batches(Events)
    w.append_insert(b[0])
    w.append_insert(b[2])
    w.rotate()  # a checkpoint at seq 2 would rotate here
    w.append_marker(port_wal.KIND_SEAL)
    w.rotate()
    assert w.prune(3) == 2  # both closed segments are covered
    assert w.segments() == ["seg_000000000004.wal"]
    w.close()
    r = WriteAheadLog(str(tmp_path))
    assert r.last_seq == 3 and list(r.records()) == []
    assert r.append_insert(b[0]) == 4
