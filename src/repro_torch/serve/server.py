"""`TNKDEServer` — snapshot-isolated, micro-batched TN-KDE query serving.

Ties the serving subsystem together (DESIGN.md §6):

    submit() ── pins (profile, epoch, snapshot) ──▶ MicroBatcher queues
    insert()/seal() ── move the DRFS epochs; queued requests keep their pins
    pump() ── forms micro-batches ──▶ cache probe ──▶ ONE window-batched
              engine pass per batch against the batch's snapshot ──▶ rows
              cached, responses assembled (lixel slicing, QueryStats)

A server hosts one or more **profiles** — named `TNKDE` models over the
same network/events that differ in bandwidths, kernels or quantization
(the "multiple temporal KDEs" of the paper, §8.2). Heterogeneous requests
are compatible for coalescing exactly when they share a profile and a
pinned epoch; the scheduler never mixes snapshots inside a batch.

Single-threaded by design: admission, mutation and pumping interleave in
one control loop (the load generator's), and MVCC — not locking — is what
keeps a long micro-batch consistent while inserts land between pumps.

Every model runs on ``device`` (the card by default; ``device='cpu'`` runs
the kernels' plain versions on the host). Where the reference audits its
jit caches, this package audits its compiled CUDA libraries
(:func:`jit_entries`): ``warmup()`` loads every library the serving path
launches, and steady-state serving then loads none.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import TNKDE
from repro_torch.core import wal as walmod
from repro_torch.core.events import Events
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.kernels import _build

from . import errors as _errors
from .cache import ResultCache
from .continuous import ContinuousCore
from .errors import ServeError, ServeRejected
from .scheduler import MicroBatch, MicroBatcher, Request, window_class

__all__ = [
    "ProfileConfig",
    "RequestStats",
    "Response",
    "ServerStats",
    "TNKDEServer",
    "jit_entries",
]


def jit_entries() -> int:
    """The compile audit: the number of CUDA libraries this process has
    built or loaded (``kernels._build``, one per ``csrc`` source). The name
    and its 0-growth contract are the reference's (its jit-cache probe): a
    steady-state run that adds none loaded no kernel it had not warmed."""
    return len(_build._LIBS)


@dataclasses.dataclass
class ProfileConfig:
    """One served model configuration (a bandwidth/kernel/quantization mix)."""

    g: float = 50.0
    b_s: float = 1000.0
    b_t: float = 86400.0
    spatial_kernel: str = "triangular"
    temporal_kernel: str = "triangular"
    solution: str = "drfs"
    engine: str = "auto"
    # the device executor ('auto' = 'packed'; 'fused', 'kernel'): this
    # package's name for the tiers the reference reaches through
    # engine='pallas'
    executor: str = "auto"
    lixel_sharing: bool = False
    drfs_depth: int = 8
    drfs_h0: Optional[int] = None
    drfs_exact_leaf: bool = False
    # auto_seal=False moves the geometric seal off the insert path; the
    # server then runs it as background compaction between pumps
    # (maybe_compact). horizon_s bounds the profile's event history to a
    # sliding window — expired events are evicted at compaction (WAL-logged
    # once at server level; profiles may have heterogeneous horizons).
    auto_seal: bool = True
    horizon_s: Optional[float] = None

    def to_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RequestStats:
    """Per-request roll-up attached to every Response."""

    epoch: Tuple[int, int]  # pinned (revision, pend_revision)
    queue_seconds: float  # admission -> batch execution start
    service_seconds: float  # the batch's engine wall time (shared)
    batch_size: int  # requests coalesced into the batch
    windows_evaluated: int  # padded centers the batch sent to the engine
    cache_hits: int  # this request's centers served from cache
    cache_misses: int
    atoms: int  # engine atoms the batch flushed (shared roll-up)


@dataclasses.dataclass
class Response:
    id: int
    tag: object
    heat: Optional[np.ndarray]  # [len(ts), L] (or [len(ts), len(lixels)]);
    # None on an error response — check ``ok`` before touching it
    stats: RequestStats
    ok: bool = True
    error: Optional[ServeError] = None


@dataclasses.dataclass
class ServerStats:
    n_requests: int = 0
    n_batches: int = 0
    n_windows_requested: int = 0  # sum of len(req.ts)
    n_windows_evaluated: int = 0  # padded engine centers actually flushed
    n_rows_computed: int = 0  # distinct (epoch, center) rows evaluated
    queue_seconds: float = 0.0
    service_seconds: float = 0.0
    # ---- fault-tolerance counters (DESIGN.md §8) ----
    n_shed: int = 0  # admissions rejected at max_queued (QueueFull)
    n_expired: int = 0  # requests whose deadline passed before execution
    n_errors: int = 0  # ok=False responses issued
    n_engine_faults: int = 0  # engine passes that raised
    n_retries: int = 0  # transient faults retried (once, after backoff)
    n_degradations: int = 0  # executor-ladder trips (fused->packed->numpy)
    n_stragglers: int = 0  # flushes the step watchdog flagged as slow
    # ---- background compaction (sliding horizon) ----
    n_compactions: int = 0  # compact() passes that did work
    n_sealed_events: int = 0  # pending events merged by compaction seals
    n_evicted: int = 0  # events expired past the sliding horizon
    # ---- continuous engine (DESIGN.md §10) ----
    n_flushes: int = 0  # continuous dispatches (incl. pure-cache-hit ones)
    occupancy_sum: float = 0.0  # sum over flushes of slots_taken / n_slots
    slots_occupied: int = 0  # gauge: occupied slots after the last pump
    n_hopeless_shed: int = 0  # SLO admission sheds (deadline_hopeless)
    # ---- fleet fault tolerance (DESIGN.md §11) ----
    n_cancelled: int = 0  # waiting requests removed via cancel()

    @property
    def batch_occupancy(self) -> float:
        """Mean filled/capacity across continuous flushes — the headline
        slot-utilization number of the continuous engine."""
        return self.occupancy_sum / self.n_flushes if self.n_flushes else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_occupancy"] = round(self.batch_occupancy, 4)
        return d


class TNKDEServer:
    def __init__(
        self,
        net,
        events: Events,
        profiles: Optional[Dict[str, ProfileConfig]] = None,
        *,
        mode: str = "continuous",
        batch_cap: int = 8,
        window_cap: int = 16,
        cache_rows: int = 4096,
        max_queued: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        degrade_after: Optional[int] = None,
        retry_backoff_s: float = 0.01,
        watchdog: Optional[StepWatchdog] = None,
        auto_compact: bool = True,
        n_slots: int = 32,
        inflight_depth: int = 2,
        flush_cap: Optional[int] = None,
        slo_margin: Optional[float] = None,
        device="cuda",
    ):
        """``mode`` selects the execution core: ``'continuous'`` (default)
        is the slot-scheduled, double-buffered engine of DESIGN.md §10;
        ``'microbatch'`` is the barrier-synchronized batcher (kept for
        A/B benchmarking and as the conservative fallback). ``n_slots``,
        ``inflight_depth``, ``flush_cap`` and ``slo_margin`` configure the
        continuous core and are ignored under ``'microbatch'``;
        ``batch_cap`` is the micro-batcher's per-batch request cap.

        ``device`` is passed to every profile's model. The reference's
        ``mesh``/``shard_axes`` (sharded profiles) are not part of this
        package yet (ROADMAP.md Queue A8).

        ``degrade_after`` is the number of consecutive failed flushes of a
        profile after which the server trips its model one rung down the
        executor ladder (:meth:`TNKDE.degrade`). On the CPU it defaults to
        the reference's 2. On the card it is off and may not be set: a
        kernel that fails there fails its flush with ``ENGINE_FAULT``
        responses and is never swapped for its plain version or the host
        path behind the caller's back; ``TNKDE.degrade()`` stays an
        operator's explicit call (ROADMAP.md Queue C item 6)."""
        on_card = torch.device(device).type != "cpu"
        if on_card and degrade_after is not None:
            raise ValueError(
                "degrade_after is off on the card: a failed kernel fails its "
                "flush; call TNKDE.degrade() explicitly to change executor"
            )
        if degrade_after is None and not on_card:
            degrade_after = 2
        profiles = profiles or {"default": ProfileConfig()}
        self.profiles = {
            name: (p if isinstance(p, ProfileConfig) else ProfileConfig(**p))
            for name, p in profiles.items()
        }
        self.device = device
        self.models: Dict[str, TNKDE] = {
            name: TNKDE(net, events, device=device, **cfg.to_kwargs())
            for name, cfg in self.profiles.items()
        }
        self.window_cap = int(window_cap)
        if mode not in ("continuous", "microbatch"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self.mode = mode
        if mode == "continuous":
            self.continuous: Optional[ContinuousCore] = ContinuousCore(
                self, n_slots=n_slots, inflight_depth=inflight_depth,
                flush_cap=flush_cap, slo_margin=slo_margin,
                max_queued=max_queued,
            )
            self.scheduler = self.continuous.scheduler
        else:
            self.continuous = None
            self.scheduler = MicroBatcher(
                batch_cap=batch_cap, window_cap=window_cap, max_queued=max_queued
            )
        self.cache = ResultCache(cache_rows)
        self.stats = ServerStats()
        self._next_id = 0
        # queue-depth time series (seconds since server start, n_queued),
        # sampled at every pump tail — the observability hook perf_serve.py
        # and stats_json() export (bounded: old samples roll off)
        self._t_start = time.perf_counter()
        self.depth_series = deque(maxlen=4096)
        # ---- fault envelope (DESIGN.md §8) ----
        self.default_deadline_s = default_deadline_s
        self.degrade_after = None if degrade_after is None else int(degrade_after)
        self.retry_backoff_s = float(retry_backoff_s)
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        self._fault_streak: Dict[str, int] = {}
        # ---- background compaction (DESIGN.md §9) ----
        # with auto_compact, every pump() tail runs maybe_compact(): seals
        # and horizon evictions happen between batches, never on the
        # insert or query path (profiles opt in via auto_seal=False)
        self.auto_compact = bool(auto_compact)
        # ---- durability (server-level WAL + coordinated checkpoints) ----
        self._wal = None
        self._ckpt_step = 0

    # ------------------------------------------------------------ admission
    def submit(
        self,
        ts: Sequence[float],
        *,
        profile: str = "default",
        lixels: Optional[np.ndarray] = None,
        tag: object = None,
        deadline_s: Optional[float] = None,
        pin: Optional[tuple] = None,
    ) -> int:
        """Admit a query; returns its request id. The index state is pinned
        NOW — mutations issued between admission and the flush are invisible
        to this request (snapshot isolation).

        ``deadline_s`` (default: the server's ``default_deadline_s``) bounds
        the request's useful lifetime from admission: a request still queued
        past it is answered with a ``deadline_exceeded`` error Response
        instead of an engine pass. Raises :class:`~repro_torch.serve.errors.
        QueueFull` when the scheduler is at ``max_queued`` (load shedding —
        the request was NOT admitted and gets no Response).

        ``pin`` is router-internal: an ``(epoch, snapshot)`` pair captured
        from THIS server at an earlier epoch. When given, the request reads
        that pinned state instead of the current one — this is what makes
        fleet failover/hedging *exact*: a re-submitted request evaluates the
        same epoch on the new replica, bit-equal modulo engine tolerance.
        """
        model = self.models[profile]  # KeyError = unknown profile
        arrival = time.perf_counter()
        ttl = deadline_s if deadline_s is not None else self.default_deadline_s
        epoch, snapshot = (
            (model.epoch, None) if pin is None else (pin[0], pin[1])
        )
        req = Request(
            id=self._next_id,
            profile=profile,
            ts=tuple(float(t) for t in ts),
            epoch=epoch,
            lixels=None if lixels is None else np.asarray(lixels, np.int64),
            tag=tag,
            arrival=arrival,
            deadline=None if ttl is None else arrival + float(ttl),
        )
        try:
            self.scheduler.admit(req, model.snapshot() if pin is None else snapshot)
        except ServeRejected:
            self.stats.n_shed += 1
            raise
        self._next_id += 1
        return req.id

    def cancel(
        self,
        *,
        request_id: Optional[int] = None,
        tag: object = None,
        pred=None,
    ) -> int:
        """Cancel waiting requests by id, tag, or predicate; returns the
        number removed. In-flight requests (continuous mode, dispatched but
        unretired) are NOT cancellable — their late answer is the caller's
        to drop. Cancelled requests get no Response."""
        if pred is None:
            def pred(r, _id=request_id, _tag=tag):
                if _id is not None and r.id != _id:
                    return False
                if _tag is not None and r.tag != _tag:
                    return False
                return _id is not None or _tag is not None
        sched = self.continuous if self.continuous is not None else self.scheduler
        removed = sched.cancel(pred)
        self.stats.n_cancelled += len(removed)
        return len(removed)

    @property
    def n_queued(self) -> int:
        return self.scheduler.n_queued

    @property
    def load(self) -> int:
        """Least-loaded routing metric: queue depth PLUS in-flight slot
        occupancy. ``n_queued`` alone counts a dispatched-but-unretired
        request once, same as an idle queued one — so a replica mid-flush
        (device busy) would tie with a truly idle replica. Double-counting
        in-flight slots breaks that tie toward the idle device."""
        extra = 0
        if self.continuous is not None:
            extra = self.continuous.scheduler.slots_inflight
        return self.scheduler.n_queued + extra

    @property
    def has_ready_batch(self) -> bool:
        if self.continuous is not None:
            return self.continuous.has_ready_batch
        return self.scheduler.has_ready_batch

    # ------------------------------------------------------------ mutation
    def insert(self, events: Events) -> None:
        """Streaming insertion into every profile (epochs move; queued
        requests keep serving their pinned snapshots)."""
        bad = [n for n, m in self.models.items() if m.solution != "drfs"]
        if bad:
            raise ValueError(
                f"insert() requires every profile to be streaming (drfs); "
                f"static profiles: {bad}"
            )
        if self._wal is not None:
            # logged ONCE at server level before any model mutates: every
            # profile consumes the same mutation stream, so one record set
            # recovers them all (the models themselves stay log-less)
            self._wal.append_insert(events)
        for name, model in self.models.items():
            model.insert(events)
            floor = self.scheduler.oldest_epoch(name)
            self.cache.prune_below(
                name, model.epoch if floor is None else min(floor, model.epoch)
            )

    def seal(self) -> None:
        """Force-merge pending buffers on every streaming profile."""
        if self._wal is not None and any(
            m.solution == "drfs" for m in self.models.values()
        ):
            self._wal.append_marker(walmod.KIND_SEAL)
        for model in self.models.values():
            if model.solution == "drfs":
                model.index.seal()

    # ------------------------------------------ background compaction (§9)
    def compact(self, t_now: Optional[float] = None) -> dict:
        """One compaction pass over every streaming profile: evict events
        past each profile's sliding horizon, then seal pending buffers.

        Durability mirrors :meth:`insert`: the EVICT record (carrying the
        resolved stream time) and the SEAL marker are logged ONCE at server
        level, before any model mutates — on replay every profile applies
        its own ``horizon_s`` cutoff against the logged time, so one record
        set recovers heterogeneous horizons (horizon-less profiles no-op).
        Queued requests keep answering from their pinned snapshots (MVCC);
        the result cache is pruned below the still-pinned floor like any
        other mutation. Returns ``{"evicted": n, "sealed": n}`` totals.
        """
        drfs = {n: m for n, m in self.models.items() if m.solution == "drfs"}
        out = {"evicted": 0, "sealed": 0}
        if not drfs:
            return out
        if t_now is None:
            t_now = max(m.stream_t_max for m in drfs.values())
        t_now = float(t_now)
        will_evict = any(
            m.horizon_s is not None
            and (m.index.n_sealed + m.index.n_pending)
            and m._ee_tmin < t_now - m.horizon_s
            for m in drfs.values()
        )
        will_seal = any(m.index.n_pending for m in drfs.values())
        if self._wal is not None:
            # log-before-apply, once for all profiles (models are log-less)
            if will_evict:
                self._wal.append_evict(t_now)
            if will_seal:
                self._wal.append_marker(walmod.KIND_SEAL)
        for name, model in drfs.items():
            r = model.compact(t_now)
            out["evicted"] += r["evicted"]
            out["sealed"] += r["sealed"]
            if r["evicted"] or r["sealed"]:
                floor = self.scheduler.oldest_epoch(name)
                self.cache.prune_below(
                    name, model.epoch if floor is None else min(floor, model.epoch)
                )
        if out["evicted"] or out["sealed"]:
            self.stats.n_compactions += 1
            self.stats.n_evicted += out["evicted"]
            self.stats.n_sealed_events += out["sealed"]
        return out

    def maybe_compact(self) -> Optional[dict]:
        """The pump-tail hook: compact when some profile needs it and no
        full batch is waiting (compaction yields to ready query work — it
        can always run one pump later, queries cannot)."""
        if not self.auto_compact or self.has_ready_batch:
            return None
        if any(
            m.solution == "drfs" and m.needs_compaction
            for m in self.models.values()
        ):
            return self.compact()
        return None

    # ------------------------------------------------------------ execution
    def pump(self, *, force: bool = True) -> List[Response]:
        """Run the execution core; returns completed responses. Under
        ``mode='continuous'`` this delegates to the slot engine (admit →
        flush groups → double-buffered dispatch → per-slot retirement);
        under ``'microbatch'`` it forms and executes barrier micro-batches.
        ``force=False`` executes only full batches/groups (the load
        generator's linger policy decides when to force a drain).

        Never raises: every admitted request gets exactly one Response —
        engine faults, deadline expiry and unexpected internal bugs all
        convert to ``ok=False`` responses, so one bad batch cannot take
        down the serving loop or the other profiles.
        """
        if self.continuous is not None:
            responses = self.continuous.pump(force=force)
            self.maybe_compact()
            self._record_depth()
            return responses
        responses = []
        for batch in self.scheduler.form_batches(force=force):
            try:
                responses.extend(self._execute(batch))
            except Exception as e:  # defense in depth: _execute already
                # converts engine faults; this catches its own bugs. Safe
                # against double-answering: _execute assembles its response
                # list and returns it at the end, so a raise means NO
                # response from this batch was delivered.
                t = time.perf_counter()
                err = ServeError(
                    code=_errors.INTERNAL, message=f"{type(e).__name__}: {e}"
                )
                responses.extend(
                    self._error_response(r, batch, t, err) for r in batch.requests
                )
                self.stats.n_batches += 1
        self.maybe_compact()
        self._record_depth()
        return responses

    def _record_depth(self) -> None:
        self.depth_series.append(
            (time.perf_counter() - self._t_start, self.n_queued)
        )

    # ---------------- response/fault helpers shared by both cores ----------
    def _mk_stats(
        self,
        *,
        epoch: Tuple[int, int],
        queue_seconds: float,
        n_ts: int,
        service_seconds: float = 0.0,
        batch_size: int = 0,
        windows_evaluated: int = 0,
        cache_hits: int = 0,
        atoms: int = 0,
    ) -> RequestStats:
        return RequestStats(
            epoch=epoch,
            queue_seconds=queue_seconds,
            service_seconds=service_seconds,
            batch_size=batch_size,
            windows_evaluated=windows_evaluated,
            cache_hits=cache_hits,
            cache_misses=n_ts - cache_hits,
            atoms=atoms,
        )

    def _mk_ok_response(self, req: Request, heat, stats: RequestStats) -> Response:
        self.stats.n_requests += 1
        self.stats.n_windows_requested += len(req.ts)
        self.stats.queue_seconds += stats.queue_seconds
        return Response(id=req.id, tag=req.tag, heat=heat, stats=stats)

    def _mk_error_response(
        self, req: Request, stats: RequestStats, err: ServeError
    ) -> Response:
        self.stats.n_requests += 1
        self.stats.n_windows_requested += len(req.ts)
        self.stats.queue_seconds += stats.queue_seconds
        self.stats.n_errors += 1
        return Response(
            id=req.id, tag=req.tag, heat=None, stats=stats, ok=False, error=err
        )

    def _error_response(
        self, req: Request, batch: MicroBatch, t_start: float, err: ServeError
    ) -> Response:
        stats = self._mk_stats(
            epoch=batch.epoch,
            queue_seconds=t_start - req.arrival,
            n_ts=len(req.ts),
            batch_size=len(batch.requests),
        )
        return self._mk_error_response(req, stats, err)

    def _fault_error(self, e: Exception) -> ServeError:
        """Account one engine fault and type it for the Response."""
        self.stats.n_engine_faults += 1
        return ServeError(
            code=_errors.ENGINE_FAULT,
            message=f"{type(e).__name__}: {e}",
            retryable=bool(getattr(e, "transient", False)),
        )

    def _note_flush_failed(self, profile: str) -> None:
        """Bump the profile's consecutive-failed-flush streak; at
        ``degrade_after`` (never on the card) the executor degradation
        ladder trips (``TNKDE.degrade``: fused → packed → numpy) so the next
        flush answers on the slower rung instead of failing."""
        streak = self._fault_streak.get(profile, 0) + 1
        self._fault_streak[profile] = streak
        if self.degrade_after is not None and streak >= self.degrade_after:
            if self.models[profile].degrade() is not None:
                self.stats.n_degradations += 1
            self._fault_streak[profile] = 0

    def _query_guarded(self, batch: MicroBatch, eval_ts: List[float]):
        """One engine pass inside the §8 fault envelope: the step watchdog
        times the flush (slow ones count as stragglers), a *transient*
        fault gets ONE retry after a short backoff, and a failed flush
        bumps the per-profile streak (:meth:`_note_flush_failed`).
        Returns ``(heat, None)`` or ``(None, ServeError)`` — never raises.
        """
        model = self.models[batch.profile]
        err: Optional[ServeError] = None
        for attempt in (0, 1):
            self.watchdog.step_start()
            try:
                F = model.query(list(eval_ts), at=batch.snapshot)
            except Exception as e:
                self.watchdog.step_end()
                err = self._fault_error(e)
                if getattr(e, "transient", False) and attempt == 0:
                    self.stats.n_retries += 1
                    if self.retry_backoff_s > 0:
                        time.sleep(self.retry_backoff_s)
                    continue
                break
            if self.watchdog.step_end():
                self.stats.n_stragglers += 1
            self._fault_streak[batch.profile] = 0
            return F, None
        self._note_flush_failed(batch.profile)
        return None, err

    def _execute(self, batch: MicroBatch) -> List[Response]:
        model = self.models[batch.profile]
        t_start = time.perf_counter()
        out: List[Response] = []
        live: List[Request] = []
        for req in batch.requests:
            if req.deadline is not None and t_start >= req.deadline:
                self.stats.n_expired += 1
                out.append(
                    self._error_response(
                        req,
                        batch,
                        t_start,
                        ServeError(
                            code=_errors.DEADLINE_EXCEEDED,
                            message=(
                                "deadline exceeded before execution (queued "
                                f"{t_start - req.arrival:.4f}s)"
                            ),
                        ),
                    )
                )
            else:
                live.append(req)
        if not live:
            self.stats.n_batches += 1
            return out
        # distinct centers of the LIVE requests only — expired ones must not
        # widen the engine pass they no longer participate in
        seen: "OrderedDict[float, None]" = OrderedDict()
        for r in live:
            for t in r.ts:
                seen.setdefault(float(t))
        rowmap: Dict[float, np.ndarray] = {}
        misses: List[float] = []
        for c in seen:
            row = self.cache.get(ResultCache.key(batch.profile, batch.epoch, c))
            if row is None:
                misses.append(c)
            else:
                rowmap[c] = row
        atoms0 = model.stats.n_atoms
        n_eval = 0
        if misses:
            # pad the distinct-center count to its window class by repeating
            # a real center: O(log cap) flush widths in total
            wc = window_class(len(misses), self.window_cap)
            eval_ts = misses + [misses[0]] * (wc - len(misses))
            n_eval = len(eval_ts)
            F, err = self._query_guarded(batch, eval_ts)
            if F is None:
                # the whole batch shared one failed engine pass: isolate the
                # fault to these requests (per-request error Responses), the
                # serving loop and the other queues keep going
                out.extend(self._error_response(r, batch, t_start, err) for r in live)
                self.stats.n_batches += 1
                return out
            for i, c in enumerate(misses):
                # copy: a view would pin the whole padded [W, L] batch array
                # in the cache for as long as the row lives
                row = F[i].copy()
                rowmap[c] = row
                self.cache.put(ResultCache.key(batch.profile, batch.epoch, c), row)
        service = time.perf_counter() - t_start
        atoms = model.stats.n_atoms - atoms0
        miss_set = set(misses)
        L = model.n_lixels
        for req in live:
            heat = (
                np.stack([rowmap[float(t)] for t in req.ts])
                if req.ts
                else np.zeros((0, L))
            )
            if req.lixels is not None:
                heat = heat[:, req.lixels]
            hits = sum(1 for t in req.ts if float(t) not in miss_set)
            stats = RequestStats(
                epoch=batch.epoch,
                queue_seconds=t_start - req.arrival,
                service_seconds=service,
                batch_size=len(batch.requests),
                windows_evaluated=n_eval,
                cache_hits=hits,
                cache_misses=len(req.ts) - hits,
                atoms=atoms,
            )
            out.append(Response(id=req.id, tag=req.tag, heat=heat, stats=stats))
            self.stats.n_requests += 1
            self.stats.n_windows_requested += len(req.ts)
            self.stats.queue_seconds += stats.queue_seconds
        self.stats.n_batches += 1
        self.stats.n_windows_evaluated += n_eval
        self.stats.n_rows_computed += len(misses)
        self.stats.service_seconds += service
        return out

    # --------------------------------------------------------------- warmup
    def warmup(self, *, profiles: Optional[Sequence[str]] = None) -> dict:
        """Build and load every kernel the serving path can launch, at each
        profile's CURRENT index state, so steady-state serving loads no
        library (the ``jit_entries`` audit then reads 0 growth across a
        measured run).

        For each profile, one probe query of the widest window class
        (``window_cap`` centres spread across the profile's event time
        span). The reference probes every rung of the padding ladder
        (:func:`~repro_torch.serve.scheduler.window_class` over
        ``1..window_cap``) because XLA compiles once per shape; this
        package's kernels take the window count at run time and one library
        holds every form a profile's executor launches, so one probe loads
        it. Probes run against the live index (no snapshot pin) and bypass
        the result cache, so warmup leaves serving state untouched apart
        from the libraries it loads and the engines' caches.

        A degradation to another executor can load one more library
        afterwards; run ``warmup()`` again after restore/bulk-load to
        re-establish the guarantee. Returns a report with before/after
        library counts (``jit_entries_*``) and the window class probed
        (``window_classes``).
        """
        t0 = time.perf_counter()
        before = jit_entries()
        ladder = [window_class(self.window_cap, self.window_cap)]
        warmed: Dict[str, List[int]] = {}
        for name in list(self.models) if profiles is None else list(profiles):
            model = self.models[name]
            lo, hi = float(model.ee.t_min), float(model.ee.t_max)
            if not (np.isfinite(lo) and np.isfinite(hi)):
                warmed[name] = []  # no events: nothing reaches the engines
                continue
            for wc in ladder:
                ts = np.linspace(lo + 0.25 * (hi - lo), hi, wc)
                model.query([float(t) for t in ts])
            warmed[name] = ladder
        return {
            "profiles": warmed,
            "window_classes": ladder,
            "jit_entries_before": before,
            "jit_entries_after": jit_entries(),
            "seconds": round(time.perf_counter() - t0, 4),
        }

    # -------------------------------------------------------- observability
    def stats_json(self) -> dict:
        """The observability export (consumed by ``benchmarks/perf_serve``
        and the CLI's final report): counter roll-ups plus the continuous
        engine's gauges and the bounded queue-depth time series."""
        d = self.stats.as_dict()
        d["mode"] = self.mode
        d["n_queued"] = self.n_queued
        d["n_slots"] = (
            self.continuous.scheduler.n_slots if self.continuous is not None else 0
        )
        d["inflight_depth"] = (
            self.continuous.inflight_depth if self.continuous is not None else 0
        )
        d["jit_entries"] = jit_entries()
        d["queue_depth"] = [
            [round(t, 6), int(q)] for t, q in self.depth_series
        ]
        return d

    # ----------------------------------------------------------- durability
    def attach_wal(self, wal) -> None:
        """Server-level WAL (DESIGN.md §8): every ``insert``/``seal`` is
        logged ONCE here before the per-profile models mutate."""
        self._wal = wal

    def checkpoint(
        self, ckpt_dir: str, *, step: Optional[int] = None, keep_last: int = 3
    ) -> int:
        """Coordinated checkpoint: seal (logged), then persist every
        streaming profile under ``<ckpt_dir>/<profile>`` at ONE sequence
        number, then rotate + prune the WAL. A crash mid-way leaves
        profiles at different committed steps — :meth:`restore` replays
        each profile from its OWN step, which re-converges them.

        ``step`` overrides the sequence number: the fleet router passes its
        own WAL's ``last_seq`` when checkpointing through a replica whose
        local ``_wal`` is None (mutations are logged once at router level)."""
        self.seal()
        if step is not None:
            seq = int(step)
        else:
            seq = self._wal.last_seq if self._wal is not None else self._ckpt_step + 1
        for name, model in self.models.items():
            if model.solution == "drfs":
                model.checkpoint(
                    os.path.join(ckpt_dir, name), step=seq, keep_last=keep_last
                )
        self._ckpt_step = seq
        if self._wal is not None:
            self._wal.rotate()
            self._wal.prune(seq)
        return seq

    def restore(self, ckpt_dir=None, *, wal=None, attach: bool = True):
        """Crash recovery for the whole server: each streaming profile
        restores its latest committed checkpoint (if any) and replays the
        shared WAL suffix past its own sequence number; the result cache is
        dropped (epochs moved). Returns an aggregate
        :class:`~repro_torch.core.wal.RecoveryReport` (worst-case per-profile
        replay depth; wall times summed)."""
        agg = walmod.RecoveryReport(
            restored_step=None,
            from_seq=0,
            to_seq=0,
            n_truncated_bytes=wal.truncated_bytes if wal is not None else 0,
        )
        first = True
        for name, model in self.models.items():
            if model.solution != "drfs":
                continue
            rep = model.restore(
                None if ckpt_dir is None else os.path.join(ckpt_dir, name),
                wal=wal,
                attach=False,  # the WAL belongs to the server, not the model
            )
            agg.restore_seconds += rep.restore_seconds
            agg.replay_seconds += rep.replay_seconds
            if first or (rep.from_seq < agg.from_seq):
                agg.restored_step = rep.restored_step
                agg.from_seq = rep.from_seq
                agg.n_records = rep.n_records
                agg.n_events = rep.n_events
            agg.to_seq = max(agg.to_seq, rep.to_seq)
            first = False
        if wal is not None and attach:
            self._wal = wal
        self.cache = ResultCache(self.cache.max_rows)
        return agg
