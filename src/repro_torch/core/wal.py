"""Write-ahead log for the streaming TN-KDE index (DESIGN.md §8).

Durability contract: every mutation of the DRFS index — an ``insert`` event
batch, an explicit ``seal``, an ``extend`` — is appended here, checksummed
and fsync'd, **before** the in-memory structure mutates. A process that
dies at any instant can therefore rebuild the exact pre-crash state by
restoring the latest committed checkpoint (``ckpt/checkpoint.py``) and
replaying the records past the checkpoint's sequence number: DRFS evolution
is a deterministic function of the operation sequence (position bisection
is data-independent, the geometric auto-seal threshold depends only on
counts, and Φ moments are recomputed from the logged raw events by the
same code path), so replay reproduces the uncrashed run bit-for-bit.

Sliding-horizon **eviction** is the one mutation that is NOT a pure
function of the operation sequence so far — its cutoff depends on the
stream clock the compactor resolved at runtime — so it is logged as an
explicit EVICT record carrying that resolved time. Replay re-applies each
model's own ``t_now - horizon_s`` cutoff against the logged ``t_now``,
which is why one server-level record serves profiles with heterogeneous
horizons (horizon-less models no-op deterministically).

Layout — a directory of **segments**, rotated at every checkpoint so
replay cost is bounded by the checkpoint cadence and fully-covered
segments can be pruned::

    <dir>/seg_000000000001.wal     # records seq 1..k
    <dir>/seg_0000000000k+1.wal    # records seq k+1.. (rotated at ckpt)

Record format (little-endian, append-only)::

    <u32 magic> <u8 kind> <u64 seq> <u32 payload_len> <u32 crc32(payload)>
    <payload_len bytes>

``kind``: 1=INSERT (payload = n:u64, edge i64[n], pos f64[n], time f64[n]),
2=SEAL, 3=EXTEND (empty payloads), 4=EVICT (payload = t_now f64, the
resolved stream time the horizon cutoff derives from). A **torn final
record** — short header,
short payload, bad magic or bad CRC at the tail of the *last* segment — is
exactly what a crash mid-append leaves behind; it is detected and truncated
(never partially applied). The same damage anywhere else is corruption and
raises :class:`WalError`.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Optional

import numpy as np

from .events import Events

__all__ = [
    "KIND_INSERT",
    "KIND_SEAL",
    "KIND_EXTEND",
    "KIND_EVICT",
    "RecoveryReport",
    "WalError",
    "WalRecord",
    "WriteAheadLog",
]

_MAGIC = 0x57414C31  # "WAL1"
_HDR = struct.Struct("<IBQII")  # magic, kind, seq, payload_len, payload_crc

KIND_INSERT = 1
KIND_SEAL = 2
KIND_EXTEND = 3
KIND_EVICT = 4


class WalError(RuntimeError):
    """Unrecoverable log damage: a bad record *before* the tail of the last
    segment (a torn tail is recoverable and handled by truncation)."""


@dataclasses.dataclass
class WalRecord:
    seq: int
    kind: int
    events: Optional[Events] = None  # INSERT payload; None otherwise
    t_now: Optional[float] = None  # EVICT payload; None otherwise


@dataclasses.dataclass
class RecoveryReport:
    """What a ``TNKDE.restore`` actually did — the recovery-time telemetry
    ``benchmarks/perf_recovery.py`` turns into BENCH_recovery.json rows."""

    restored_step: Optional[int]  # checkpoint step restored (None = from seed)
    from_seq: int  # first replayed record is from_seq + 1
    to_seq: int  # last applied sequence number
    n_records: int = 0
    n_events: int = 0  # events inside replayed INSERT batches
    n_evicted: int = 0  # events removed by replayed EVICT records
    n_truncated_bytes: int = 0  # torn tail removed before replay
    restore_seconds: float = 0.0
    replay_seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _encode_insert(events: Events) -> bytes:
    n = events.n
    return b"".join(
        (
            struct.pack("<Q", n),
            np.ascontiguousarray(events.edge_id, dtype="<i8").tobytes(),
            np.ascontiguousarray(events.pos, dtype="<f8").tobytes(),
            np.ascontiguousarray(events.time, dtype="<f8").tobytes(),
        )
    )


def _decode_insert(payload: bytes) -> Events:
    (n,) = struct.unpack_from("<Q", payload)
    off = 8
    expect = 8 + 24 * n
    if len(payload) != expect:
        raise WalError(f"insert payload length {len(payload)} != {expect}")
    edge = np.frombuffer(payload, dtype="<i8", count=n, offset=off)
    pos = np.frombuffer(payload, dtype="<f8", count=n, offset=off + 8 * n)
    time = np.frombuffer(payload, dtype="<f8", count=n, offset=off + 16 * n)
    return Events(edge.copy(), pos.copy(), time.copy())


def _scan_segment(path: str) -> tuple[List[WalRecord], int, int]:
    """Parse one segment; returns (records, good_end_offset, file_size).

    Parsing stops at the first record that does not fully check out
    (short header/payload, bad magic, bad CRC); ``good_end_offset`` is the
    byte offset of everything before it. The *caller* decides whether the
    remainder is a recoverable torn tail (last segment) or corruption.
    """
    with open(path, "rb") as f:
        buf = f.read()
    records: List[WalRecord] = []
    off = 0
    size = len(buf)
    while True:
        if off + _HDR.size > size:
            break
        magic, kind, seq, plen, crc = _HDR.unpack_from(buf, off)
        if magic != _MAGIC or off + _HDR.size + plen > size:
            break
        payload = buf[off + _HDR.size : off + _HDR.size + plen]
        if zlib.crc32(payload) != crc:
            break
        if kind == KIND_INSERT:
            rec = WalRecord(seq=seq, kind=kind, events=_decode_insert(payload))
        elif kind == KIND_EVICT:
            if plen != 8:
                raise WalError(f"evict payload length {plen} != 8")
            rec = WalRecord(seq=seq, kind=kind, t_now=struct.unpack("<d", payload)[0])
        elif kind in (KIND_SEAL, KIND_EXTEND):
            rec = WalRecord(seq=seq, kind=kind)
        else:
            break  # unknown kind: treat as damage at this offset
        records.append(rec)
        off += _HDR.size + plen
    return records, off, size


class WriteAheadLog:
    """Appender + reader over a WAL directory.

    Opening scans every segment: damage before the tail of the last segment
    raises :class:`WalError`; a torn tail on the last segment is truncated
    on the spot (a crash mid-append left it — the record never took effect,
    because appends complete *before* the in-memory mutation starts).

    ``fsync=False`` trades the per-append fsync for speed (benchmarks; a
    kernel crash may then lose the OS-buffered suffix, a process crash
    cannot, since the bytes are already in the page cache).
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.last_seq = 0
        self.truncated_bytes = 0  # torn tail removed when opening
        self._fh = None  # lazily opened append handle
        self._segment: Optional[str] = None  # active segment file name
        os.makedirs(path, exist_ok=True)
        segs = self.segments()
        for i, name in enumerate(segs):
            full = os.path.join(path, name)
            records, good_end, size = _scan_segment(full)
            if good_end != size:
                if i != len(segs) - 1:
                    raise WalError(
                        f"corrupt record inside non-final segment {name} "
                        f"(offset {good_end})"
                    )
                with open(full, "rb+") as f:
                    f.truncate(good_end)
                self.truncated_bytes = size - good_end
            if records:
                self.last_seq = records[-1].seq
            else:
                # an empty segment still pins the sequence: rotation creates
                # it eagerly and its name encodes first_seq, so a reopen
                # after rotate+prune (all records' segments deleted) must
                # not restart numbering inside the pruned range — replay
                # after the covering checkpoint would skip the reused seqs
                self.last_seq = max(self.last_seq, self._first_seq_of(name) - 1)
        self._segment = segs[-1] if segs else None

    # ------------------------------------------------------------- segments
    def segments(self) -> List[str]:
        return sorted(
            n for n in os.listdir(self.path)
            if n.startswith("seg_") and n.endswith(".wal")
        )

    @staticmethod
    def _segment_name(first_seq: int) -> str:
        return f"seg_{first_seq:012d}.wal"

    @staticmethod
    def _first_seq_of(name: str) -> int:
        return int(name.split("_")[1].split(".")[0])

    def _handle(self):
        if self._fh is None:
            if self._segment is None:
                self._segment = self._segment_name(self.last_seq + 1)
            self._fh = open(os.path.join(self.path, self._segment), "ab")
        return self._fh

    def rotate(self) -> None:
        """Start a new segment (called after a checkpoint commits): replay
        after that checkpoint never has to read the closed segments, and
        :meth:`prune` may delete the fully-covered ones."""
        self.close()
        self._segment = None
        self._handle()  # eagerly create seg_{last_seq+1}, so a prune issued
        # right after rotation already sees the closed segments as covered

    def prune(self, upto_seq: int) -> int:
        """Delete segments whose every record is <= ``upto_seq`` (covered by
        a committed checkpoint). The active segment is never deleted."""
        segs = self.segments()
        removed = 0
        for i, name in enumerate(segs[:-1]):
            next_first = self._first_seq_of(segs[i + 1])
            if next_first <= upto_seq + 1 and name != self._segment:
                os.remove(os.path.join(self.path, name))
                removed += 1
        return removed

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -------------------------------------------------------------- appends
    def _append(self, kind: int, payload: bytes) -> int:
        seq = self.last_seq + 1
        fh = self._handle()
        fh.write(_HDR.pack(_MAGIC, kind, seq, len(payload), zlib.crc32(payload)))
        fh.write(payload)
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        self.last_seq = seq
        return seq

    def append_insert(self, events: Events) -> int:
        """Log an insert batch; durable before this returns."""
        return self._append(KIND_INSERT, _encode_insert(events))

    def append_marker(self, kind: int) -> int:
        """Log a SEAL or EXTEND marker (EVICT carries a payload — use
        :meth:`append_evict`)."""
        if kind not in (KIND_SEAL, KIND_EXTEND):
            raise ValueError(f"not a marker kind: {kind}")
        return self._append(kind, b"")

    def append_evict(self, t_now: float) -> int:
        """Log a horizon eviction at resolved stream time ``t_now``;
        durable before this returns (logged before the eviction applies,
        like every mutation)."""
        return self._append(KIND_EVICT, struct.pack("<d", float(t_now)))

    # -------------------------------------------------------------- reading
    def records(self, after_seq: int = 0) -> Iterator[WalRecord]:
        """Yield committed records with seq > ``after_seq`` in order.

        Reads from disk (fresh handles), so a reader sees exactly what a
        recovering process would; the torn tail was already truncated at
        open time. Sequence numbers must be strictly increasing — a gap or
        repeat means segments were tampered with, and raises.
        """
        prev = None
        for i, name in enumerate(self.segments()):
            records, good_end, size = _scan_segment(os.path.join(self.path, name))
            if good_end != size:
                raise WalError(f"unexpected damage in segment {name}")
            for rec in records:
                if prev is not None and rec.seq <= prev:
                    raise WalError(
                        f"non-monotone sequence {rec.seq} after {prev} in {name}"
                    )
                prev = rec.seq
                if rec.seq > after_seq:
                    yield rec
