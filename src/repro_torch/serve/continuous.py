"""Continuous-batching slot engine — the default server core (DESIGN.md §10).

The micro-batcher (`scheduler`) is barrier-synchronized: a popped batch owns the
engine until every member retires, admission waits, and the next batch
forms from scratch. This module replaces that loop with the slot-scheduled
continuous batching of the MaxText offline-inference style:

* **Slots.** A fixed table of ``n_slots`` request slots. Admission drops a
  request into any free slot immediately — *while a flush is in flight* —
  and an overflow queue (bounded by ``max_queued``) buffers the rest in
  deadline order (EDF). Slots retire per-flush and refill from overflow
  without waiting for the rest of the pipeline to drain.
* **Flush groups.** A flush takes occupied idle slots sharing one
  ``(profile, epoch)`` — the MVCC compatibility key, so a flush can never
  straddle a mutation — capped at ``window_cap`` distinct centers /
  ``flush_cap`` slots. Distinct missed centers pad to their window class
  (:func:`~repro_torch.serve.scheduler.window_class`), the same ladder as
  the micro-batcher.
* **Double-buffered dispatch.** ``TNKDE.dispatch`` enqueues the device
  flush on the card's stream (CUDA launches and host-to-device copies
  return at once; nothing in ``dispatch`` waits for the card) and returns
  a :class:`~repro_torch.core.tnkde.PendingQuery`; the core keeps up to
  ``inflight_depth`` (default 2) flushes in flight — the host packs and
  enqueues flush N+1 while the device still runs flush N, then blocks on
  flush N's result (the one device-to-host copy). Each flush's [L, W]
  heatmap comes from PyTorch's caching allocator, so the pipeline
  recycles buffers instead of asking the driver for memory per flush.
* **SLO admission.** Overflow drains earliest-deadline-first; requests
  whose deadline already passed — or, with ``slo_margin``, whose deadline
  lands inside ``slo_margin ×`` the flush-time EWMA — are shed with a
  typed ``deadline_hopeless`` response *before* spending a slot.
* **Fault envelope.** Same contract as the micro-batcher (DESIGN.md §8):
  dispatch/result faults convert to typed per-request error Responses
  (retry-once on transient, per-profile streaks trip the degradation
  ladder), and a faulted flush always frees its slots — a slot is never
  lost. ``pump`` never raises.

Rows computed by an in-flight flush are not yet in the result cache when
the next flush packs, so the dispatch probe also dedups against the
pipeline itself: a center an earlier in-flight flush (same profile+epoch)
is already computing becomes a **deferred row** — the later flush skips the
engine for it and resolves it from the cache at retire time, which is safe
because flushes retire FIFO (the feeder always lands first). If the feeder
faulted, the deferred rows are recomputed with one guarded synchronous
pass, so a sibling's fault never corrupts (only slows) a flush.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import errors as _errors
from .cache import ResultCache
from .errors import QueueFull, ServeError
from .scheduler import Request, window_class

__all__ = ["ContinuousCore", "InFlightFlush", "SlotScheduler"]


class _Slot:
    __slots__ = ("idx", "req", "inflight")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: Optional[Request] = None  # None = free
        self.inflight = False  # member of a dispatched, unretired flush


def _edf_key(req: Request) -> Tuple[float, float]:
    """Earliest-deadline-first with arrival-order tiebreak; deadline-less
    requests sort last (they can always wait)."""
    return (req.deadline if req.deadline is not None else float("inf"),
            req.arrival)


def _group_full(reqs: List[Request], window_cap: int, flush_cap: int) -> bool:
    """A group worth dispatching without force: a whole flush of slots, or
    a full window batch of distinct centers."""
    if len(reqs) >= flush_cap:
        return True
    centers = {float(t) for r in reqs for t in r.ts}
    return len(centers) >= window_cap


class SlotScheduler:
    """Fixed slot table + bounded EDF overflow queue.

    The slot table is the admission surface of continuous batching: a free
    slot means a request joins the *running* batch cycle right away; the
    overflow queue only exists so bursts beyond ``n_slots`` shed at a
    configured bound (``max_queued``) instead of at the slot count.
    """

    def __init__(self, n_slots: int = 32, max_queued: Optional[int] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if max_queued is not None and max_queued < 1:
            raise ValueError("max_queued must be >= 1 (or None = unbounded)")
        self.n_slots = int(n_slots)
        self.max_queued = None if max_queued is None else int(max_queued)
        self.slots = [_Slot(i) for i in range(self.n_slots)]
        self._overflow: List[Request] = []
        # (profile, epoch) -> pinned snapshot; dropped when no holder remains
        self._snaps: Dict[Tuple[str, Tuple[int, int]], object] = {}

    # ------------------------------------------------------------ admission
    def admit(self, req: Request, snapshot: object) -> None:
        if self.max_queued is not None and self.n_queued >= self.max_queued:
            raise QueueFull(
                f"scheduler at max_queued={self.max_queued}; shedding request"
            )
        self._snaps.setdefault((req.profile, req.epoch), snapshot)
        slot = self._free_slot()
        if slot is not None:
            slot.req = req
        else:
            self._overflow.append(req)

    def _free_slot(self) -> Optional[_Slot]:
        for s in self.slots:
            if s.req is None:
                return s
        return None

    def fill_slots(self) -> None:
        """Drain overflow into free slots, earliest deadline first."""
        if not self._overflow:
            return
        self._overflow.sort(key=_edf_key)
        while self._overflow:
            slot = self._free_slot()
            if slot is None:
                return
            slot.req = self._overflow.pop(0)

    def pop_hopeless(self, horizon: float) -> List[Request]:
        """Remove and return waiting requests (idle slots + overflow, never
        in-flight ones) whose deadline falls before ``horizon`` — the SLO
        shed set. In-flight requests keep their slots: their engine pass is
        already paid for, so the answer ships even if late."""
        out: List[Request] = []
        keep: List[Request] = []
        for req in self._overflow:
            (out if req.deadline is not None and req.deadline < horizon
             else keep).append(req)
        self._overflow = keep
        for s in self.slots:
            if (s.req is not None and not s.inflight
                    and s.req.deadline is not None and s.req.deadline < horizon):
                out.append(s.req)
                s.req = None
        if out:
            self._gc_snaps()
        return out

    def cancel(self, pred) -> List[Request]:
        """Remove and return WAITING requests matching ``pred`` (idle slots
        + overflow, never in-flight ones — their engine pass is already paid
        for, so cancellation races resolve by dropping the late answer, not
        by yanking a dispatched flush). The fleet router uses this to kill
        the slower copy of a hedged pair and to drain a replica it is
        quarantining; cancelled requests get NO Response from this server —
        the caller owns their accounting."""
        out: List[Request] = []
        keep: List[Request] = []
        for req in self._overflow:
            (out if pred(req) else keep).append(req)
        self._overflow = keep
        for s in self.slots:
            if s.req is not None and not s.inflight and pred(s.req):
                out.append(s.req)
                s.req = None
        if out:
            self._gc_snaps()
        return out

    # ------------------------------------------------------------- queries
    @property
    def n_queued(self) -> int:
        """Admitted, unanswered requests — occupied slots (idle AND
        in-flight) plus overflow: the load drivers loop until 0."""
        return sum(1 for s in self.slots if s.req is not None) + len(self._overflow)

    @property
    def slots_occupied(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    @property
    def slots_inflight(self) -> int:
        """Slots whose request is dispatched but not yet retired — work the
        device is actively holding. The router's least-loaded metric counts
        these on top of ``n_queued`` so a replica mid-flush outranks one
        with the same queue depth but an idle device."""
        return sum(1 for s in self.slots if s.req is not None and s.inflight)

    @property
    def overflow_depth(self) -> int:
        return len(self._overflow)

    def idle_slots(self) -> List[_Slot]:
        return [s for s in self.slots if s.req is not None and not s.inflight]

    def oldest_arrival(self) -> Optional[float]:
        """Oldest WAITING request (idle slot or overflow) — the linger
        clock. In-flight requests are excluded: they are already being
        served, lingering no longer applies to them."""
        arrivals = [s.req.arrival for s in self.idle_slots()]
        arrivals += [r.arrival for r in self._overflow]
        return min(arrivals) if arrivals else None

    def oldest_epoch(self, profile: str) -> Optional[Tuple[int, int]]:
        """Oldest epoch still pinned by an unanswered request of
        ``profile`` — the result-cache pruning floor."""
        epochs = [s.req.epoch for s in self.slots
                  if s.req is not None and s.req.profile == profile]
        epochs += [r.epoch for r in self._overflow if r.profile == profile]
        return min(epochs) if epochs else None

    def n_queued_for(self, profile: str) -> int:
        return (sum(1 for s in self.slots
                    if s.req is not None and s.req.profile == profile)
                + sum(1 for r in self._overflow if r.profile == profile))

    # ------------------------------------------------------------ grouping
    def head_group(self, window_cap: int, flush_cap: int, *, force: bool = True):
        """Pop the next flush group: idle occupied slots sharing one
        ``(profile, epoch)``, groups considered in age order (oldest member
        first — aging, no starvation). Without ``force``, a group only
        dispatches when it is *full* (:func:`_group_full`) or the slot
        table is saturated (a flush must retire to reopen admission) —
        the exact analogue of the micro-batcher's linger contract, and the
        invariant ``has_ready_group`` relies on: ready implies a
        ``force=False`` pump makes progress. Members join in arrival order
        until the union of distinct centers would exceed ``window_cap`` (a
        single oversized request still ships alone) or ``flush_cap`` slots
        are taken. Returns ``(slots, snapshot)`` or ``(None, None)``.
        """
        idle = self.idle_slots()
        if not idle:
            return None, None
        groups: "OrderedDict[Tuple[str, Tuple[int, int]], List[_Slot]]" = OrderedDict()
        for s in sorted(idle, key=lambda s: s.req.arrival):
            groups.setdefault((s.req.profile, s.req.epoch), []).append(s)
        saturated = self._free_slot() is None
        chosen = None
        for key, group in groups.items():
            if (force or saturated
                    or _group_full([s.req for s in group], window_cap, flush_cap)):
                chosen = (key, group)
                break
        if chosen is None:
            return None, None
        key, group = chosen
        take: List[_Slot] = []
        centers: set = set()
        for s in group:
            union = centers | {float(t) for t in s.req.ts}
            if take and len(union) > window_cap:
                break
            take.append(s)
            centers = union
            if len(take) >= flush_cap:
                break
        for s in take:
            s.inflight = True
        return take, self._snaps[key]

    def has_ready_group(self, window_cap: int, flush_cap: int) -> bool:
        """True iff ``head_group(force=False)`` would return a group."""
        idle = self.idle_slots()
        if not idle:
            return False
        if self._free_slot() is None:
            return True
        groups: Dict[Tuple[str, Tuple[int, int]], List[Request]] = {}
        for s in idle:
            groups.setdefault((s.req.profile, s.req.epoch), []).append(s.req)
        return any(_group_full(g, window_cap, flush_cap) for g in groups.values())

    def retire(self, slots: List[_Slot]) -> None:
        """Free a flush group's slots (they refill from overflow on the
        next fill_slots) and drop snapshot pins nobody holds anymore."""
        for s in slots:
            s.req = None
            s.inflight = False
        self._gc_snaps()

    def _gc_snaps(self) -> None:
        live = {(s.req.profile, s.req.epoch)
                for s in self.slots if s.req is not None}
        live |= {(r.profile, r.epoch) for r in self._overflow}
        for key in [k for k in self._snaps if k not in live]:
            del self._snaps[key]


class InFlightFlush:
    """One dispatched, unretired flush: the slots it owns, the pinned
    snapshot, the cache rows it reused and the PendingQuery it blocks on."""

    __slots__ = ("slots", "profile", "epoch", "snapshot", "misses", "rowmap",
                 "deferred", "pending", "n_eval", "t_dispatch", "atoms",
                 "error")

    def __init__(self, slots, profile, epoch, snapshot):
        self.slots = slots
        self.profile = profile
        self.epoch = epoch
        self.snapshot = snapshot
        self.misses: List[float] = []  # distinct centers needing the engine
        self.deferred: List[float] = []  # centers an earlier in-flight flush
        # at this (profile, epoch) is already computing; resolved at retire
        self.rowmap: Dict[float, np.ndarray] = {}
        self.pending = None  # PendingQuery; None = pure cache hit or fault
        self.n_eval = 0  # padded centers sent to the engine
        self.t_dispatch = 0.0
        self.atoms = 0
        self.error: Optional[ServeError] = None  # dispatch-stage fault

    @property
    def requests(self) -> List[Request]:
        return [s.req for s in self.slots]


class ContinuousCore:
    """The slot-scheduled, double-buffered execution core of
    :class:`~repro_torch.serve.server.TNKDEServer` (``mode='continuous'``).

    Owns admission (slots + EDF overflow + SLO shed) and the
    dispatch/retire pipeline; mutation, durability, compaction, the result
    cache and the fault-accounting policy stay on the server (shared with
    the micro-batch core). The server's ``pump()`` delegates here.
    """

    def __init__(self, server, *, n_slots: int = 32,
                 inflight_depth: int = 2, flush_cap: Optional[int] = None,
                 slo_margin: Optional[float] = None,
                 max_queued: Optional[int] = None):
        if inflight_depth < 1:
            raise ValueError("inflight_depth must be >= 1")
        self.server = server
        self.scheduler = SlotScheduler(n_slots=n_slots, max_queued=max_queued)
        self.inflight_depth = int(inflight_depth)
        # batch-class cap: slots one flush may take. Compiled shapes are
        # window-class-determined (the request axis is host-side assembly),
        # so this bounds host packing latency per flush, not compile count.
        self.flush_cap = int(flush_cap) if flush_cap else self.scheduler.n_slots
        if self.flush_cap < 1:
            raise ValueError("flush_cap must be >= 1")
        self.slo_margin = None if slo_margin is None else float(slo_margin)
        self._inflight: List[InFlightFlush] = []
        # flush-time EWMA (dispatch -> retire wall) driving the SLO shed
        self.flush_ewma_s: Optional[float] = None

    # ------------------------------------------------------------ admission
    def admit(self, req: Request, snapshot: object) -> None:
        self.scheduler.admit(req, snapshot)

    @property
    def n_queued(self) -> int:
        return self.scheduler.n_queued

    def cancel(self, pred) -> List[Request]:
        """Per-request cancellation hook (see SlotScheduler.cancel)."""
        return self.scheduler.cancel(pred)

    @property
    def has_ready_batch(self) -> bool:
        return self.scheduler.has_ready_group(
            self.server.window_cap, self.flush_cap
        )

    # ------------------------------------------------------------ SLO shed
    def _shed_hopeless(self, now: float) -> List:
        """Typed deadline responses for requests that cannot make their
        SLO: already expired, or (with ``slo_margin``) due before the
        EWMA-predicted flush completion."""
        horizon = now
        if self.slo_margin is not None and self.flush_ewma_s is not None:
            horizon = now + self.slo_margin * self.flush_ewma_s
        out = []
        server = self.server
        for req in self.scheduler.pop_hopeless(horizon):
            expired = req.deadline is not None and req.deadline <= now
            if expired:
                code, msg = _errors.DEADLINE_EXCEEDED, (
                    "deadline exceeded before execution (queued "
                    f"{now - req.arrival:.4f}s)"
                )
                server.stats.n_expired += 1
            else:
                code, msg = _errors.DEADLINE_HOPELESS, (
                    f"shed as hopeless: deadline in {req.deadline - now:.4f}s "
                    "< predicted service "
                    f"{self.slo_margin * self.flush_ewma_s:.4f}s"
                )
                server.stats.n_hopeless_shed += 1
            stats = server._mk_stats(
                epoch=req.epoch, queue_seconds=now - req.arrival,
                n_ts=len(req.ts),
            )
            out.append(server._mk_error_response(req, stats, ServeError(
                code=code, message=msg, retryable=not expired,
            )))
        return out

    # ------------------------------------------------------------ dispatch
    def _dispatch_next(self, *, force: bool) -> Optional[InFlightFlush]:
        server = self.server
        slots, snapshot = self.scheduler.head_group(
            server.window_cap, self.flush_cap, force=force
        )
        if not slots:
            return None
        req0 = slots[0].req
        fl = InFlightFlush(slots, req0.profile, req0.epoch, snapshot)
        fl.t_dispatch = time.perf_counter()
        try:
            # distinct centers in arrival order; probe the epoch-keyed cache
            seen: "OrderedDict[float, None]" = OrderedDict()
            for s in slots:
                for t in s.req.ts:
                    seen.setdefault(float(t))
            # rows an earlier in-flight flush at this key is already
            # computing: defer instead of duplicating the engine work
            computing = {c for f2 in self._inflight
                         if (f2.profile, f2.epoch) == (fl.profile, fl.epoch)
                         and f2.error is None
                         for c in f2.misses}
            for c in seen:
                row = server.cache.get(ResultCache.key(fl.profile, fl.epoch, c))
                if row is not None:
                    fl.rowmap[c] = row
                elif c in computing:
                    fl.deferred.append(c)
                else:
                    fl.misses.append(c)
            server.stats.n_flushes += 1
            server.stats.occupancy_sum += len(slots) / self.scheduler.n_slots
            if not fl.misses:
                return fl  # cache hits + deferred rows: no engine pass
            model = server.models[fl.profile]
            wc = window_class(len(fl.misses), server.window_cap)
            eval_ts = fl.misses + [fl.misses[0]] * (wc - len(fl.misses))
            fl.n_eval = len(eval_ts)
            atoms0 = model.stats.n_atoms
            try:
                fl.pending = model.dispatch(eval_ts, at=fl.snapshot)
            except Exception as e:
                # engine/injector fault at dispatch: the §8 envelope resolves
                # it at retire time (retry-once if transient)
                fl.error = server._fault_error(e)
            fl.atoms = model.stats.n_atoms - atoms0
        except Exception as e:  # defense in depth: a bug in the probe/pack
            # path itself must not lose the group's slots
            fl.error = ServeError(
                code=_errors.INTERNAL, message=f"{type(e).__name__}: {e}"
            )
        return fl

    # -------------------------------------------------------------- retire
    def _retire(self, fl: InFlightFlush) -> List:
        server = self.server
        err = fl.error
        F = None
        if err is None and fl.pending is not None:
            try:
                F = fl.pending.result()  # blocks on the device
            except Exception as e:
                err = server._fault_error(e)
        if err is not None and err.retryable and fl.misses:
            # transient fault: ONE synchronous retry, like _query_guarded
            server.stats.n_retries += 1
            if server.retry_backoff_s > 0:
                time.sleep(server.retry_backoff_s)
            try:
                wc = window_class(len(fl.misses), server.window_cap)
                eval_ts = fl.misses + [fl.misses[0]] * (wc - len(fl.misses))
                F = server.models[fl.profile].query(eval_ts, at=fl.snapshot)
                err = None
            except Exception as e:
                err = server._fault_error(e)
        service = time.perf_counter() - fl.t_dispatch
        if fl.pending is not None:
            # engine flushes only: cache hits must not skew the SLO shed
            # predictor or the straggler baseline
            self.flush_ewma_s = (
                service if self.flush_ewma_s is None
                else 0.8 * self.flush_ewma_s + 0.2 * service
            )
            if server.watchdog.record(service):
                server.stats.n_stragglers += 1
        if err is None and fl.deferred:
            # the feeder flush has retired (FIFO) — its rows are in the
            # cache unless it faulted, in which case we pay one guarded
            # synchronous pass for the leftovers
            missing = []
            for c in fl.deferred:
                row = server.cache.get(ResultCache.key(fl.profile, fl.epoch, c))
                if row is None:
                    missing.append(c)
                else:
                    fl.rowmap[c] = row
            if missing:
                try:
                    wc = window_class(len(missing), server.window_cap)
                    ets = missing + [missing[0]] * (wc - len(missing))
                    F2 = server.models[fl.profile].query(ets, at=fl.snapshot)
                    for i, c in enumerate(missing):
                        row = F2[i].copy()
                        fl.rowmap[c] = row
                        server.cache.put(
                            ResultCache.key(fl.profile, fl.epoch, c), row
                        )
                    server.stats.n_windows_evaluated += len(ets)
                    server.stats.n_rows_computed += len(missing)
                except Exception as e:
                    err = server._fault_error(e)
        out: List = []
        if err is not None:
            server._note_flush_failed(fl.profile)
            for req in fl.requests:
                stats = server._mk_stats(
                    epoch=fl.epoch, queue_seconds=fl.t_dispatch - req.arrival,
                    n_ts=len(req.ts), batch_size=len(fl.slots),
                )
                out.append(server._mk_error_response(req, stats, err))
        else:
            if F is not None:
                server._fault_streak[fl.profile] = 0
                for i, c in enumerate(fl.misses):
                    # copy: a view would pin the whole padded [W, L] batch
                    row = F[i].copy()
                    fl.rowmap[c] = row
                    server.cache.put(
                        ResultCache.key(fl.profile, fl.epoch, c), row
                    )
            L = server.models[fl.profile].n_lixels
            miss_set = set(fl.misses)
            for s in fl.slots:
                req = s.req
                heat = (np.stack([fl.rowmap[float(t)] for t in req.ts])
                        if req.ts else np.zeros((0, L)))
                if req.lixels is not None:
                    heat = heat[:, req.lixels]
                hits = sum(1 for t in req.ts if float(t) not in miss_set)
                stats = server._mk_stats(
                    epoch=fl.epoch,
                    queue_seconds=fl.t_dispatch - req.arrival,
                    service_seconds=service,
                    batch_size=len(fl.slots),
                    windows_evaluated=fl.n_eval,
                    cache_hits=hits,
                    n_ts=len(req.ts),
                    atoms=fl.atoms,
                )
                out.append(server._mk_ok_response(req, heat, stats))
            server.stats.n_windows_evaluated += fl.n_eval
            server.stats.n_rows_computed += len(fl.misses)
            server.stats.service_seconds += service
        self.scheduler.retire(fl.slots)
        server.stats.n_batches += 1
        return out

    def _fail_flush(self, fl: InFlightFlush, e: Exception) -> List:
        """Last-resort conversion of a ``_retire`` bug into per-request
        internal errors; the slots are freed regardless."""
        server = self.server
        err = ServeError(code=_errors.INTERNAL, message=f"{type(e).__name__}: {e}")
        out = []
        for req in fl.requests:
            stats = server._mk_stats(
                epoch=fl.epoch, queue_seconds=fl.t_dispatch - req.arrival,
                n_ts=len(req.ts), batch_size=len(fl.slots),
            )
            out.append(server._mk_error_response(req, stats, err))
        self.scheduler.retire(fl.slots)
        server.stats.n_batches += 1
        return out

    # ----------------------------------------------------------------- pump
    def pump(self, *, force: bool = True) -> List:
        """The continuous serving loop body.

        Each cycle: shed hopeless work, refill slots from overflow (EDF),
        prime the dispatch pipeline up to ``inflight_depth`` flushes — the
        host packs and enqueues flush N+1 while the device still runs
        flush N — then retire the OLDEST in-flight flush (the only
        blocking point). ``force=False`` dispatches only full groups (the
        linger contract), runs one cycle and returns, keeping the driver's
        arrival loop responsive; ``force=True`` cycles until nothing is
        queued or in flight. Never raises: faults become typed error
        Responses and always free their slots.
        """
        server = self.server
        out: List = []
        while True:
            now = time.perf_counter()
            out.extend(self._shed_hopeless(now))
            self.scheduler.fill_slots()
            while len(self._inflight) < self.inflight_depth:
                fl = self._dispatch_next(force=force)
                if fl is None:
                    break
                self._inflight.append(fl)
            if not self._inflight:
                break
            fl = self._inflight.pop(0)
            try:
                out.extend(self._retire(fl))
            except Exception as e:  # defense in depth (see _fail_flush)
                out.extend(self._fail_flush(fl, e))
            if not force:
                break
        server.stats.slots_occupied = self.scheduler.slots_occupied
        return out
