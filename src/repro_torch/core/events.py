"""Event sets (paper Def 3.3): an event o_i = (p_i, t_i) lies on an edge at a
position (metres from the edge's src endpoint) and carries a timestamp.

``EdgeEvents`` is the canonical per-edge, time-sorted CSR layout every index in
this package (ADA / RFS / DRFS) consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .network import RoadNetwork

__all__ = [
    "Events",
    "EdgeEvents",
    "EventCountsView",
    "EventValidationError",
    "group_events_by_edge",
    "group_by_edge_csr",
    "ragged_arange",
    "validate_events",
]


class EventValidationError(ValueError):
    """A streamed event batch failed ingest validation (bad edge id,
    out-of-range position, non-finite time). Raised by
    :func:`validate_events` *before* the batch touches the WAL or any
    in-memory state — a rejected batch leaves the log, the index and the
    planner exactly as they were."""


def validate_events(net: RoadNetwork, ev: Events) -> None:
    """Reject invalid insert batches with a typed error, pre-mutation.

    Checks, vectorized over the batch: edge ids in ``[0, n_edges)``,
    positions finite and inside ``[0, edge_len]`` (no silent clipping on
    the write path — a producer bug must surface, not be laundered into
    the durable log), and finite timestamps. The first offending index is
    named so producers can find the bad record.
    """
    if ev.n == 0:
        return
    eid = ev.edge_id
    bad = (eid < 0) | (eid >= net.n_edges)
    if bad.any():
        i = int(np.argmax(bad))
        raise EventValidationError(
            f"event {i}: edge_id {int(eid[i])} outside [0, {net.n_edges})"
        )
    if not np.isfinite(ev.time).all():
        i = int(np.argmax(~np.isfinite(ev.time)))
        raise EventValidationError(f"event {i}: non-finite time {ev.time[i]!r}")
    finite_pos = np.isfinite(ev.pos)
    lens = net.edge_len[eid]
    bad = ~finite_pos | (ev.pos < 0.0) | (ev.pos > lens)
    if bad.any():
        i = int(np.argmax(bad))
        raise EventValidationError(
            f"event {i}: pos {ev.pos[i]!r} outside [0, {lens[i]!r}] "
            f"on edge {int(eid[i])}"
        )


def ragged_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flatten the ragged ranges [starts[i], starts[i]+counts[i]) in order.

    The standard repeat/arange trick every scan path here uses to enumerate
    per-segment event slots without a Python loop.
    """
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    rep = np.repeat(np.asarray(starts, np.int64), counts)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    return rep + off


def group_by_edge_csr(n_edges: int, edge: np.ndarray, time: np.ndarray):
    """CSR (ptr [E+1], order [N]) grouping events by edge, time-sorted within.

    ``order`` permutes the caller's parallel arrays into CSR layout. Shared by
    the DRFS pending buffers and the device engine's pending upload.
    """
    order = np.lexsort((time, edge))
    ptr = np.zeros(n_edges + 1, dtype=np.int64)
    np.add.at(ptr, np.asarray(edge, np.int64) + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, order


@dataclasses.dataclass
class Events:
    """Flat event set. ``edge_id[i]``, ``pos[i]`` (metres from edge src,
    clipped to [0, len]), ``time[i]`` (seconds, arbitrary epoch)."""

    edge_id: np.ndarray  # int32 [N]
    pos: np.ndarray  # float64 [N]
    time: np.ndarray  # float64 [N]

    def __post_init__(self):
        self.edge_id = np.asarray(self.edge_id, dtype=np.int32)
        self.pos = np.asarray(self.pos, dtype=np.float64)
        self.time = np.asarray(self.time, dtype=np.float64)

    @property
    def n(self) -> int:
        return int(self.edge_id.shape[0])

    def time_span(self):
        if self.n == 0:
            return 0.0, 1.0
        return float(self.time.min()), float(self.time.max())


@dataclasses.dataclass
class EdgeEvents:
    """Events grouped per edge and sorted by time within each edge.

    ``ptr`` is [E+1]; the slice [ptr[e], ptr[e+1]) holds edge e's events in
    ascending *time* order (the range-forest version axis, §4.1). ``pos`` is
    the distance from the edge's src endpoint (= the paper's d(v_c, p_i)).
    """

    ptr: np.ndarray  # int64 [E+1]
    pos: np.ndarray  # float64 [N]
    time: np.ndarray  # float64 [N]
    t_min: float
    t_max: float

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])

    def count(self, e: int) -> int:
        return int(self.ptr[e + 1] - self.ptr[e])

    def slice(self, e: int):
        lo, hi = int(self.ptr[e]), int(self.ptr[e + 1])
        return self.pos[lo:hi], self.time[lo:hi]


@dataclasses.dataclass
class EventCountsView:
    """Counts-only event view for the streaming planner (write path).

    Once a DRFS model starts streaming, the planner no longer needs the
    full merged (pos, time) arrays — candidate pruning and the self-edge
    flag consume only per-edge **counts** (``ptr``/``count``), the LS
    extremes live in ``TNKDE.ev_min_pos``/``ev_max_pos``, and the event
    payloads themselves live in the index (sealed arrays + pending CSR).
    This view quacks like :class:`EdgeEvents` for planning while costing
    O(E) to refresh instead of the O(N log N) full ``merge_edge_events``
    rebuild per insert. ``t_min``/``t_max`` are stream telemetry, tracked
    incrementally by the model.
    """

    ptr: np.ndarray  # int64 [E+1]
    t_min: float
    t_max: float

    @property
    def n(self) -> int:
        return int(self.ptr[-1])

    def count(self, e: int) -> int:
        return int(self.ptr[e + 1] - self.ptr[e])


def merge_edge_events(net: RoadNetwork, ee: EdgeEvents, ev: Events) -> EdgeEvents:
    """Merge a new event batch into an existing EdgeEvents (streaming)."""
    counts = np.diff(ee.ptr)
    edge_old = np.repeat(np.arange(net.n_edges, dtype=np.int32), counts)
    pos_new = np.clip(ev.pos, 0.0, net.edge_len[ev.edge_id] if ev.n else 0.0)
    merged = Events(
        edge_id=np.concatenate([edge_old, ev.edge_id]),
        pos=np.concatenate([ee.pos, pos_new]),
        time=np.concatenate([ee.time, ev.time]),
    )
    return group_events_by_edge(net, merged)


def group_events_by_edge(net: RoadNetwork, ev: Events) -> EdgeEvents:
    if ev.n and (ev.edge_id.min() < 0 or ev.edge_id.max() >= net.n_edges):
        raise ValueError("event edge_id out of range")
    pos = np.clip(ev.pos, 0.0, net.edge_len[ev.edge_id] if ev.n else 0.0)
    # stable sort by (edge, time)
    order = np.lexsort((ev.time, ev.edge_id))
    eid, pos, time = ev.edge_id[order], pos[order], ev.time[order]
    ptr = np.zeros(net.n_edges + 1, dtype=np.int64)
    np.add.at(ptr, eid + 1, 1)
    np.cumsum(ptr, out=ptr)
    t_min, t_max = (float(time.min()), float(time.max())) if ev.n else (0.0, 1.0)
    return EdgeEvents(ptr=ptr, pos=pos, time=time, t_min=t_min, t_max=t_max)
