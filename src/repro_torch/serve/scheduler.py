"""Admission + micro-batching scheduler (DESIGN.md §6).

Requests are admitted into per-``(profile, epoch)`` queues — the epoch pair
``(revision, pend_revision)`` pinned at admission is both the MVCC read
version and the batching compatibility key: every request in a micro-batch
shares one immutable snapshot, so a batch can never straddle a mutation.

Batch formation coalesces queued requests until either the request cap or
the window cap is reached; the union of the batch's distinct window centers
is evaluated in ONE window-batched engine pass (the multiple-temporal-KDE
hot path, DESIGN.md §4) and each request is served its own rows. The
evaluated center count is padded up to its **window class** — the ladder
1, 2, then even counts up to ``window_cap`` (see :func:`window_class`) —
by repeating a real center. The ladder is the reference package's, kept so
both packages evaluate the same padded batches (bit-comparable rows): the
port's kernels are compiled once per source, not per shape, so the ladder
is what ``TNKDEServer.warmup`` walks, not what bounds compilation.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Request", "MicroBatch", "MicroBatcher", "window_class"]


def window_class(n: int, cap: int) -> int:
    """Pad a distinct-center count to its window class: 1, 2, even counts
    to 16, then multiples of 8. The class set below ``cap`` stays small
    enough to warm exhaustively (9 classes at cap 16, 15 at cap 64) while
    bounding padding waste: at most ONE evaluated window below 16 (the
    marginal window is the engines' cheapest unit, but on gather-bound
    hosts it is far from free, so pow-of-two padding would throw away real
    throughput), at most 7 above — where the window-batched flush is
    already strongly sublinear in W, so the waste is cheap. The coarse
    rungs bound the distinct flush widths of the continuous engine's large
    slot batches (DESIGN.md §10). Counts above ``cap`` (one oversized
    request shipping alone) round to their own class.
    """
    n = max(int(n), 1)
    if n <= 2:
        c = n
    elif n <= 16:
        c = -(-n // 2) * 2
    else:
        c = -(-n // 8) * 8
    return c if n > cap else min(c, cap)


@dataclasses.dataclass
class Request:
    """One admitted query: window centers against a pinned snapshot."""

    id: int
    profile: str
    ts: Tuple[float, ...]
    epoch: Tuple[int, int]
    lixels: Optional[np.ndarray]  # lixel subset (None = full heatmap)
    tag: object  # caller correlation handle (load generators use it)
    arrival: float  # perf_counter timestamp at admission
    # absolute perf_counter instant after which the request is worthless;
    # the server answers it with a deadline_exceeded error Response instead
    # of spending an engine pass on it (None = no deadline)
    deadline: Optional[float] = None


@dataclasses.dataclass
class MicroBatch:
    """Coalesced unit of execution: requests sharing (profile, snapshot)."""

    profile: str
    epoch: Tuple[int, int]
    snapshot: object
    requests: List[Request]

    @property
    def centers(self) -> List[float]:
        seen: "OrderedDict[float, None]" = OrderedDict()
        for r in self.requests:
            for t in r.ts:
                seen.setdefault(float(t))
        return list(seen)


class MicroBatcher:
    def __init__(
        self,
        batch_cap: int = 8,
        window_cap: int = 16,
        max_queued: Optional[int] = None,
    ):
        if batch_cap < 1 or window_cap < 1:
            raise ValueError("batch_cap and window_cap must be >= 1")
        if max_queued is not None and max_queued < 1:
            raise ValueError("max_queued must be >= 1 (or None = unbounded)")
        self.batch_cap = int(batch_cap)
        self.window_cap = int(window_cap)
        # total queued-request bound across ALL (profile, epoch) queues —
        # the load-shedding backstop (DESIGN.md §8): beyond it, admission
        # raises QueueFull instead of letting the backlog (and every queued
        # request's pinned snapshot) grow without limit
        self.max_queued = None if max_queued is None else int(max_queued)
        # (profile, epoch) -> queued requests; insertion order = age order
        self._queues: "OrderedDict[Tuple[str, Tuple[int, int]], List[Request]]" = (
            OrderedDict()
        )
        self._snaps: Dict[Tuple[str, Tuple[int, int]], object] = {}

    # ------------------------------------------------------------ admission
    def admit(self, req: Request, snapshot: object) -> None:
        if self.max_queued is not None and self.n_queued >= self.max_queued:
            from .errors import QueueFull

            raise QueueFull(
                f"scheduler at max_queued={self.max_queued}; shedding request"
            )
        key = (req.profile, req.epoch)
        self._queues.setdefault(key, []).append(req)
        self._snaps.setdefault(key, snapshot)

    @property
    def n_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def oldest_arrival(self) -> Optional[float]:
        arrivals = [q[0].arrival for q in self._queues.values() if q]
        return min(arrivals) if arrivals else None

    def cancel(self, pred) -> List[Request]:
        """Remove and return queued requests matching ``pred``; emptied
        (profile, epoch) queues release their pinned snapshots. Micro-batch
        mode has no in-flight phase (form/execute are synchronous inside
        pump), so unlike SlotScheduler.cancel every matching request is
        cancellable."""
        out: List[Request] = []
        for key in list(self._queues):
            q = self._queues[key]
            keep = [r for r in q if not pred(r)]
            out.extend(r for r in q if pred(r))
            if keep:
                self._queues[key] = keep
            else:
                del self._queues[key]
                self._snaps.pop(key, None)
        return out

    def oldest_epoch(self, profile: str) -> Optional[Tuple[int, int]]:
        """Oldest epoch still pinned by a queued request of ``profile`` —
        the result-cache pruning floor."""
        epochs = [k[1] for k, q in self._queues.items() if k[0] == profile and q]
        return min(epochs) if epochs else None

    def n_queued_for(self, profile: str) -> int:
        """Queued requests of one profile across its epoch queues — the
        server's background compactor treats 0 as "idle enough to compact"
        (queued requests would still be correct either way: they hold
        pinned snapshots, compaction only rebinds)."""
        return sum(len(q) for k, q in self._queues.items() if k[0] == profile)

    def _full(self, q: Sequence[Request]) -> bool:
        if len(q) >= self.batch_cap:
            return True
        centers = {float(t) for r in q for t in r.ts}
        return len(centers) >= self.window_cap

    @property
    def has_ready_batch(self) -> bool:
        return any(self._full(q) for q in self._queues.values())

    # ------------------------------------------------------------ formation
    def form_batches(self, *, force: bool = True) -> List[MicroBatch]:
        """Pop micro-batches: up to ``batch_cap`` requests whose union of
        distinct centers fits ``window_cap`` (a single oversized request
        still ships alone). ``force=False`` only drains full batches —
        the load generator's linger policy decides when to force."""
        batches: List[MicroBatch] = []
        for key in list(self._queues):
            q = self._queues[key]
            while q and (force or self._full(q)):
                take: List[Request] = []
                centers: set = set()
                while q and len(take) < self.batch_cap:
                    union = centers | {float(t) for t in q[0].ts}
                    if take and len(union) > self.window_cap:
                        break
                    take.append(q.pop(0))
                    centers = union
                batches.append(
                    MicroBatch(
                        profile=key[0], epoch=key[1],
                        snapshot=self._snaps[key], requests=take,
                    )
                )
            if not q:
                del self._queues[key]
                self._snaps.pop(key, None)
        return batches
