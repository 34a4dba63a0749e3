"""Self-healing multi-replica router (DESIGN.md §11): N continuous
engines, one front door, zero single-replica trust.

A :class:`ReplicaRouter` owns ``replicas`` independent
:class:`~repro_torch.serve.server.TNKDEServer` engines built from the same
network/profile configuration and exposes the *same driving surface* as a
single server (``submit`` / ``insert`` / ``seal`` / ``compact`` / ``pump``
/ ``n_queued`` / ``has_ready_batch`` / ``scheduler.oldest_arrival``), so
the load generators and the CLI drive one replica or eight through
identical code.

**Epoch-consistent routing.** Queries route to the least-loaded HEALTHY
replica at admission; mutations apply to every active replica in the same
stream order. Because the DRFS epoch pair ``(revision, pend_revision)`` is
a pure function of the mutation sequence, all replicas walk the identical
epoch ladder, so a request pinned at epoch *e* on replica *k* reads exactly
the state any other replica exposes at *e*: the MVCC snapshot
invariants hold fleet-wide, not just per engine. That purity is ALSO what
makes failure handling exact rather than best-effort:

* **Health state machine.** Each replica is ``HEALTHY → SUSPECT →
  QUARANTINED → (RESYNCING) → HEALTHY``, driven by the signals the servers
  already emit (engine-fault responses, watchdog stragglers,
  degradation-ladder trips, mutation exceptions) through a per-replica
  circuit breaker (:class:`ReplicaHealth`: error-rate window + consecutive
  -failure threshold, half-open probes).
* **Exact failover.** At admission the router captures the pinned epoch's
  snapshot on EVERY routable replica. A request whose replica faults or is
  quarantined mid-flight is re-submitted ONCE to a healthy replica at that
  same pin — the answer is the one the original replica would have given.
* **Hedging.** A request aging on a replica whose flush EWMA has drifted
  past ``straggler_factor ×`` the fleet minimum (or that is SUSPECT) gets
  one duplicate on the next-least-loaded healthy replica; the first ``ok``
  wins, the loser is cancelled if still waiting or its late answer is
  dropped by id (``hedge_superseded`` in the ft journal).
* **Mutation quorum + resync.** A mutation that fails — or silently
  diverges the epoch ladder — on a minority of replicas quarantines the
  losers (``needs_resync``) instead of raising; the router logs mutations
  ONCE to its own WAL (replica servers are log-less), and :meth:`resync`
  rebuilds a quarantined replica from the latest checkpoint + WAL-suffix
  replay, re-verifies the epoch ladder and a ≤1e-12 spot query against a
  healthy replica, warms it, and readmits it.

Every replica runs on the same device (``device=`` of the servers, the
card by default): one ``TNKDE`` per replica and profile, each with its own
device tables. The CUDA libraries are loaded once per process
(``kernels._build``), so ``warmup()`` pays the builds once and every
replica — including a freshly resynced one — loads none.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import wal as walmod
from repro_torch.core.events import Events, validate_events

from . import errors as _errors
from .errors import ReplicaUnavailable, ServeError, ServeRejected
from .server import RequestStats, Response, TNKDEServer, jit_entries

__all__ = [
    "HEALTHY",
    "SUSPECT",
    "QUARANTINED",
    "RESYNCING",
    "ReplicaHealth",
    "ReplicaRouter",
]

# replica health states (stable strings; they appear in stats_json)
HEALTHY = "healthy"
SUSPECT = "suspect"  # half-open: probe traffic only
QUARANTINED = "quarantined"  # no traffic, no mutations
RESYNCING = "resyncing"  # transient, inside resync()


class ReplicaHealth:
    """Per-replica circuit breaker.

    Failure *responses* (engine_fault / internal) feed a rolling outcome
    window; the breaker trips to QUARANTINED on ``consec_limit``
    consecutive failures or on an error rate ≥ ``error_rate_limit`` over at
    least ``min_samples`` outcomes. Stragglers and degradation-ladder trips
    only mark SUSPECT — slow is not wrong, and a SUSPECT replica keeps
    serving probe traffic that can re-close the breaker.

    Two quarantine flavors, deliberately distinct:

    * ``needs_resync=False`` (query faults): the replica's *state* is still
      correct, only its engine is sick. After ``cooldown_pumps`` pump
      cycles the breaker half-opens (SUSPECT) and ``probe_oks_to_close``
      successful probes readmit it.
    * ``needs_resync=True`` (mutation failure/divergence, or any mutation
      applied while the replica sat quarantined): the state itself is wrong
      or behind. Half-open probing is forbidden — probes would *serve wrong
      answers* — and only :meth:`ReplicaRouter.resync` readmits.
    """

    def __init__(
        self,
        *,
        window: int = 16,
        min_samples: int = 8,
        error_rate_limit: float = 0.5,
        consec_limit: int = 3,
        probe_oks_to_close: int = 2,
        cooldown_pumps: int = 8,
    ):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.error_rate_limit = float(error_rate_limit)
        self.consec_limit = int(consec_limit)
        self.probe_oks_to_close = int(probe_oks_to_close)
        self.cooldown_pumps = int(cooldown_pumps)
        self.state = HEALTHY
        self.needs_resync = False
        self.probe_inflight = False
        self.n_trips = 0
        self._outcomes: deque = deque(maxlen=self.window)
        self._consec = 0
        self._probe_oks = 0
        self._cooldown = 0

    # ------------------------------------------------------------- signals
    def record_ok(self) -> None:
        self._outcomes.append(0)
        self._consec = 0
        self.probe_inflight = False
        if self.state == SUSPECT:
            self._probe_oks += 1
            if self._probe_oks >= self.probe_oks_to_close:
                self.state = HEALTHY
                self._outcomes.clear()
                self._probe_oks = 0

    def record_failure(self) -> bool:
        """One replica-fault-shaped failure; returns True when this signal
        trips the breaker (transition into QUARANTINED)."""
        self._outcomes.append(1)
        self._consec += 1
        self.probe_inflight = False
        self._probe_oks = 0
        if self.state == HEALTHY:
            self.state = SUSPECT
        rate = sum(self._outcomes) / len(self._outcomes)
        if self._consec >= self.consec_limit or (
            len(self._outcomes) >= self.min_samples
            and rate >= self.error_rate_limit
        ):
            return self.trip(needs_resync=False)
        return False

    def record_suspect(self) -> None:
        """Soft signal (straggler / degradation): SUSPECT, never trip."""
        if self.state == HEALTHY:
            self.state = SUSPECT
            self._probe_oks = 0

    def trip(self, *, needs_resync: bool) -> bool:
        newly = self.state != QUARANTINED
        if newly:
            self.n_trips += 1
        self.state = QUARANTINED
        self.needs_resync = self.needs_resync or needs_resync
        self.probe_inflight = False
        self._cooldown = self.cooldown_pumps
        self._consec = 0
        return newly

    def tick(self) -> None:
        """Once per router pump: walk a query-fault quarantine toward its
        half-open probe window. State-suspect quarantines stay shut."""
        if self.state == QUARANTINED and not self.needs_resync:
            self._cooldown -= 1
            if self._cooldown <= 0:
                self.state = SUSPECT
                self._outcomes.clear()
                self._probe_oks = 0

    def reset(self) -> None:
        """Full readmission (post-resync / post-restore)."""
        self.state = HEALTHY
        self.needs_resync = False
        self.probe_inflight = False
        self._outcomes.clear()
        self._consec = 0
        self._probe_oks = 0
        self._cooldown = 0

    def as_dict(self) -> dict:
        return {
            "state": self.state,
            "needs_resync": self.needs_resync,
            "n_trips": self.n_trips,
        }


class _Entry:
    """One client-visible request, across every copy the router places."""

    __slots__ = (
        "ts", "profile", "lixels", "tag", "epoch", "deadline", "t_submit",
        "replica", "keys", "hedge_key", "hedged", "failed_over", "answered",
    )

    def __init__(self, *, ts, profile, lixels, tag, epoch, deadline,
                 t_submit, replica):
        self.ts = ts
        self.profile = profile
        self.lixels = lixels
        self.tag = tag
        self.epoch = epoch
        self.deadline = deadline
        self.t_submit = t_submit
        self.replica = replica
        self.keys: List[Tuple[int, int]] = []
        self.hedge_key: Optional[Tuple[int, int]] = None
        self.hedged = False
        self.failed_over = False
        self.answered = False


class _RouterScheduler:
    """The minimal scheduler facade the load drivers touch."""

    def __init__(self, router: "ReplicaRouter"):
        self._router = router

    def oldest_arrival(self) -> Optional[float]:
        r = self._router
        arrivals = [
            a
            for k in r._active()
            for a in (r.servers[k].scheduler.oldest_arrival(),)
            if a is not None
        ]
        return min(arrivals) if arrivals else None


class ReplicaRouter:
    def __init__(
        self,
        net,
        events: Events,
        profiles=None,
        *,
        replicas: int = 2,
        hedge_ms: Optional[float] = None,
        straggler_factor: float = 3.0,
        auto_resync: bool = False,
        ckpt_dir: Optional[str] = None,
        breaker_window: int = 16,
        breaker_min_samples: int = 8,
        breaker_error_rate: float = 0.5,
        breaker_consec: int = 3,
        probe_oks: int = 2,
        cooldown_pumps: int = 8,
        **server_kw,
    ):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        # background compaction is a MUTATION: per-server auto-compaction
        # would let replicas compact at different pump cycles and walk
        # divergent ladders. The router owns it instead (maybe_compact at
        # pump tail, quorum-checked and WAL-logged once like any mutation).
        self.auto_compact = bool(server_kw.pop("auto_compact", True))
        server_kw["auto_compact"] = False
        self._net = net
        self._events = events
        self._profiles_arg = profiles
        self._server_kw = dict(server_kw)
        self.servers: List[TNKDEServer] = [
            TNKDEServer(net, events, profiles, **server_kw)
            for _ in range(replicas)
        ]
        self.scheduler = _RouterScheduler(self)
        self.health: List[ReplicaHealth] = [
            ReplicaHealth(
                window=breaker_window,
                min_samples=breaker_min_samples,
                error_rate_limit=breaker_error_rate,
                consec_limit=breaker_consec,
                probe_oks_to_close=probe_oks,
                cooldown_pumps=cooldown_pumps,
            )
            for _ in range(replicas)
        ]
        self.hedge_ms = hedge_ms
        self.straggler_factor = float(straggler_factor)
        self.auto_resync = bool(auto_resync)
        # round-robin tiebreak cursor for equally-loaded replicas: without
        # it, idle periods would route everything to replica 0
        self._rr = 0
        # (replica, rid) -> _Entry, every copy the router has placed
        self._rids: Dict[Tuple[int, int], _Entry] = {}
        self._n_outstanding = 0
        # (profile, epoch) -> {replica: snapshot}: the failover pins
        self._pins: Dict[Tuple[str, Tuple[int, int]], Dict[int, object]] = {}
        self._pin_refs: Dict[Tuple[str, Tuple[int, int]], int] = {}
        self._orphans: List[Response] = []  # router-built error responses
        self._purged = [False] * replicas
        self._wal = None
        self._ckpt_dir = ckpt_dir
        self._ckpt_step = 0
        self.ft_events: deque = deque(maxlen=256)
        self.n_failovers = 0
        self.n_hedges = 0
        self.n_hedge_wins = 0
        self.n_hedge_superseded = 0
        self.n_replica_unavailable = 0
        self.n_quarantines = 0
        self.n_resyncs = 0
        self.n_stray_dropped = 0
        self._marks: Dict[int, Tuple[int, int]] = {}

    # ------------------------------------------------------------ plumbing
    @property
    def n_replicas(self) -> int:
        return len(self.servers)

    def _active(self) -> List[int]:
        """Replicas that receive mutations and may hold traffic."""
        return [
            k for k, h in enumerate(self.health)
            if h.state in (HEALTHY, SUSPECT)
        ]

    def _routable(self) -> List[int]:
        return self._active()

    def _outstanding_on(self, k: int) -> int:
        return sum(1 for key in self._rids if key[0] == k)

    def _note_event(self, code: str, replica: int, **extra) -> None:
        ev = {"code": code, "replica": replica}
        ev.update(extra)
        self.ft_events.append(ev)

    def _ladder(self, k: int) -> tuple:
        s = self.servers[k]
        return tuple(s.models[name].epoch for name in sorted(s.models))

    # ------------------------------------------------------------- routing
    def _pick(self) -> int:
        routable = self._routable()
        if not routable:
            raise ReplicaUnavailable(
                "no HEALTHY or SUSPECT replica can take the request"
            )
        # half-open probing: one request at a time onto a suspect replica
        # with nothing else outstanding — failover covers the probe if the
        # replica is still sick, so the client never pays for the test.
        for k in routable:
            h = self.health[k]
            if (
                h.state == SUSPECT
                and not h.probe_inflight
                and self._outstanding_on(k) == 0
            ):
                return k
        healthy = [k for k in routable if self.health[k].state == HEALTHY]
        pool = healthy or routable
        loads = {k: self.servers[k].load for k in pool}
        lo = min(loads.values())
        n = len(self.servers)
        for off in range(n):
            k = (self._rr + off) % n
            if k in loads and loads[k] == lo:
                self._rr = (k + 1) % n
                return k
        return pool[0]  # unreachable

    def _capture_pins(self, profile: str, epoch: Tuple[int, int]) -> None:
        key = (profile, epoch)
        if key not in self._pins:
            snaps: Dict[int, object] = {}
            for j in self._routable():
                m = self.servers[j].models[profile]
                if m.epoch == epoch:
                    snaps[j] = m.snapshot()
            self._pins[key] = snaps
        self._pin_refs[key] = self._pin_refs.get(key, 0) + 1

    def _release_pin(self, entry: _Entry) -> None:
        key = (entry.profile, entry.epoch)
        n = self._pin_refs.get(key, 0) - 1
        if n <= 0:
            self._pin_refs.pop(key, None)
            self._pins.pop(key, None)
        else:
            self._pin_refs[key] = n

    def submit(
        self,
        ts: Sequence[float],
        *,
        profile: str = "default",
        lixels: Optional[np.ndarray] = None,
        tag: object = None,
        deadline_s: Optional[float] = None,
    ) -> Tuple[int, int]:
        """Admit on the least-loaded healthy replica (round-robin among
        ties). Returns ``(replica, request_id)`` — the id is replica-local,
        so the pair is the globally unique handle. Admission rejections
        (QueueFull) propagate from the chosen replica unchanged;
        :class:`~repro_torch.serve.errors.ReplicaUnavailable` is raised when the
        whole fleet is quarantined. The pinned epoch's snapshot is captured
        on every routable replica at admission — the failover/hedge pin."""
        k = self._pick()
        server = self.servers[k]
        rid = server.submit(
            ts, profile=profile, lixels=lixels, tag=tag, deadline_s=deadline_s
        )
        epoch = server.models[profile].epoch
        self._capture_pins(profile, epoch)
        now = time.perf_counter()
        ttl = deadline_s if deadline_s is not None else server.default_deadline_s
        entry = _Entry(
            ts=tuple(float(t) for t in ts),
            profile=profile,
            lixels=lixels,
            tag=tag,
            epoch=epoch,
            deadline=None if ttl is None else now + float(ttl),
            t_submit=now,
            replica=k,
        )
        entry.keys.append((k, rid))
        self._rids[(k, rid)] = entry
        self._n_outstanding += 1
        if self.health[k].state == SUSPECT:
            self.health[k].probe_inflight = True
        return k, rid

    # ----------------------------------------------------------- mutation
    def _mutate(self, op: str, apply_fn, *, log=None, validate=None) -> List[int]:
        """Apply one mutation to every active replica with post-hoc quorum.

        Input validation runs BEFORE the WAL append (a bad batch must not
        poison the log); the append runs BEFORE any replica mutates
        (log-before-apply). A mutation that fails on *every* replica is the
        caller's error and re-raises; a minority failure — or a success
        whose epoch ladder silently disagrees with the majority — trips the
        loser's breaker with ``needs_resync`` instead of raising. Ties on
        the ladder vote keep the LOWEST ladder: divergence-without-error
        means the loser did extra epoch work, so the conservative group is
        the correct one. Returns the winning replica indexes."""
        active = self._active()
        if not active:
            raise ReplicaUnavailable(f"no active replica for {op}")
        if validate is not None:
            validate()
        if self._wal is not None and log is not None:
            log()
        failures: Dict[int, Exception] = {}
        for k in active:
            try:
                apply_fn(self.servers[k])
            except Exception as e:  # noqa: BLE001 — per-replica fault wall
                failures[k] = e
        ok = [k for k in active if k not in failures]
        if not ok:
            raise failures[active[0]]
        ladders = {k: self._ladder(k) for k in ok}
        groups: Dict[tuple, List[int]] = {}
        for k, lad in ladders.items():
            groups.setdefault(lad, []).append(k)
        winner = sorted(groups, key=lambda lad: (-len(groups[lad]), lad))[0]
        losers = [k for k in ok if ladders[k] != winner]
        for k, e in failures.items():
            if self.health[k].trip(needs_resync=True):
                self.n_quarantines += 1
            self._note_event("mutation_fault", k, op=op, detail=repr(e))
        for k in losers:
            if self.health[k].trip(needs_resync=True):
                self.n_quarantines += 1
            self._note_event(
                "mutation_divergence", k, op=op, ladder=str(ladders[k])
            )
        for k in list(failures) + losers:
            if not self._purged[k]:
                self._orphans.extend(self._purge(k))
        # anyone who sat out this mutation is now behind: probing cannot
        # readmit it, only resync can
        winners = groups[winner]
        for k, h in enumerate(self.health):
            if h.state in (QUARANTINED, RESYNCING) and k not in winners:
                h.needs_resync = True
        return winners

    def insert(self, events: Events) -> None:
        """Apply the insert to every active replica (same stream order on
        each = identical epoch ladders), quorum-checked. Logged ONCE at
        router level when a WAL is attached — the replica servers stay
        log-less, so an N-replica fleet writes each mutation exactly once."""
        self._mutate(
            "insert",
            lambda s: s.insert(events),
            log=lambda: self._wal.append_insert(events),
            validate=lambda: validate_events(self._net, events),
        )

    def seal(self) -> None:
        def log():
            ref = self.servers[self._active()[0]]
            if any(m.solution == "drfs" for m in ref.models.values()):
                self._wal.append_marker(walmod.KIND_SEAL)

        self._mutate("seal", lambda s: s.seal(), log=log)

    def compact(self, t_now: Optional[float] = None) -> dict:
        """Router-level compaction: resolve ONE stream time and apply it to
        every active replica, so heterogeneous per-replica clocks cannot
        produce divergent evictions. WAL records (EVICT carrying the
        resolved time, SEAL) are computed against a reference replica and
        written once, before any replica mutates."""
        active = self._active()
        if not active:
            raise ReplicaUnavailable("no active replica for compact")
        ref = self.servers[active[0]]
        drfs = {n: m for n, m in ref.models.items() if m.solution == "drfs"}
        if not drfs:
            return {"evicted": 0, "sealed": 0}
        if t_now is None:
            t_now = max(m.stream_t_max for m in drfs.values())
        t_now = float(t_now)

        def log():
            will_evict = any(
                m.horizon_s is not None
                and (m.index.n_sealed + m.index.n_pending)
                and m._ee_tmin < t_now - m.horizon_s
                for m in drfs.values()
            )
            will_seal = any(m.index.n_pending for m in drfs.values())
            if will_evict:
                self._wal.append_evict(t_now)
            if will_seal:
                self._wal.append_marker(walmod.KIND_SEAL)

        out = {"evicted": 0, "sealed": 0}

        def apply(s):
            r = s.compact(t_now)
            out["evicted"] += r["evicted"]
            out["sealed"] += r["sealed"]

        self._mutate("compact", apply, log=log)
        return out

    def maybe_compact(self) -> Optional[dict]:
        """Pump-tail hook (the per-server hook is disabled fleet-wide)."""
        if not self.auto_compact or self.has_ready_batch:
            return None
        active = self._active()
        if not active:
            return None
        ref = self.servers[active[0]]
        if any(
            m.solution == "drfs" and m.needs_compaction
            for m in ref.models.values()
        ):
            return self.compact()
        return None

    # --------------------------------------------------- failover, hedging
    def _failover(
        self, entry: _Entry, *, exclude: int
    ) -> Optional[Tuple[int, int]]:
        """Re-submit ``entry`` once on a healthy replica at its ORIGINAL
        epoch pin (exact failover). Returns the new (replica, rid) key or
        None when no target exists / the deadline already passed."""
        now = time.perf_counter()
        if entry.deadline is not None and now >= entry.deadline:
            return None
        pins = self._pins.get((entry.profile, entry.epoch), {})
        cands = [
            j for j in self._routable()
            if j != exclude and j != entry.replica and j in pins
        ]
        healthy = [j for j in cands if self.health[j].state == HEALTHY]
        pool = healthy or cands
        if not pool:
            return None
        j = min(pool, key=lambda j: self.servers[j].load)
        remaining = (
            None if entry.deadline is None else max(entry.deadline - now, 1e-3)
        )
        try:
            rid = self.servers[j].submit(
                entry.ts,
                profile=entry.profile,
                lixels=entry.lixels,
                tag=entry.tag,
                deadline_s=remaining,
                pin=(entry.epoch, pins[j]),
            )
        except ServeRejected:
            return None
        entry.failed_over = True
        entry.replica = j
        key = (j, rid)
        entry.keys.append(key)
        self._rids[key] = entry
        return key

    def _other_live(self, entry: _Entry, key: Tuple[int, int]) -> bool:
        return any(k2 != key and k2 in self._rids for k2 in entry.keys)

    def _cancel_copies(self, entry: _Entry, *, exclude: Tuple[int, int]) -> None:
        """Cancel the entry's still-waiting copies (the hedge loser). A
        copy already in flight keeps its slot; its late answer is dropped
        by id when it surfaces."""
        for k2 in list(entry.keys):
            if k2 == exclude or k2 not in self._rids:
                continue
            try:
                if self.servers[k2[0]].cancel(request_id=k2[1]):
                    self._rids.pop(k2, None)
            except Exception:  # noqa: BLE001 — a dead replica can't cancel
                pass

    def _resolve(self, entry: _Entry) -> None:
        self._n_outstanding -= 1
        self._release_pin(entry)

    def _unavailable_response(self, entry: _Entry, rid: int) -> Response:
        now = time.perf_counter()
        stats = RequestStats(
            epoch=entry.epoch,
            queue_seconds=now - entry.t_submit,
            service_seconds=0.0,
            batch_size=0,
            windows_evaluated=0,
            cache_hits=0,
            cache_misses=len(entry.ts),
            atoms=0,
        )
        self.n_replica_unavailable += 1
        return Response(
            id=rid,
            tag=entry.tag,
            heat=None,
            stats=stats,
            ok=False,
            error=ServeError(
                code=_errors.REPLICA_UNAVAILABLE,
                message="no healthy replica to fail over to",
                retryable=True,
            ),
        )

    def _route_response(self, k: int, r: Response) -> List[Response]:
        """Decide one per-server response's fate: deliver, fail over, or
        drop (hedge loser / late duplicate). Exactly one Response reaches
        the client per admitted request."""
        key = (k, r.id)
        entry = self._rids.pop(key, None)
        h = self.health[k]
        h.probe_inflight = False
        if entry is None:
            # a copy the router already wrote off (e.g. in flight across a
            # quarantine-then-reopen) — dropping it is what prevents the
            # client from ever seeing a duplicate
            self.n_stray_dropped += 1
            return []
        if entry.answered:
            code = (
                _errors.HEDGE_SUPERSEDED if entry.hedged else _errors.FAILED_OVER
            )
            if entry.hedged:
                self.n_hedge_superseded += 1
            self._note_event(code, k, tag=entry.tag)
            if r.ok:
                h.record_ok()
            return []
        if r.ok:
            entry.answered = True
            self._resolve(entry)
            h.record_ok()
            if entry.hedged:
                if key == entry.hedge_key:
                    self.n_hedge_wins += 1
                self._cancel_copies(entry, exclude=key)
            return [r]
        code = r.error.code if r.error is not None else _errors.INTERNAL
        if code in (_errors.DEADLINE_EXCEEDED, _errors.DEADLINE_HOPELESS):
            # a request-level outcome, not a replica fault
            entry.answered = True
            self._resolve(entry)
            return [r]
        # replica-fault-shaped (engine_fault / internal)
        if h.record_failure():
            self.n_quarantines += 1
            self._note_event("breaker_trip", k)
        if entry.hedged and self._other_live(entry, key):
            # the other copy is still alive — let it answer
            self._note_event(_errors.FAILED_OVER, k, tag=entry.tag)
            return []
        if not entry.failed_over:
            nkey = self._failover(entry, exclude=k)
            if nkey is not None:
                self.n_failovers += 1
                self._note_event(
                    _errors.FAILED_OVER, k, to=nkey[0], tag=entry.tag
                )
                return []
        entry.answered = True
        self._resolve(entry)
        return [r]

    def _purge(self, k: int) -> List[Response]:
        """Quarantine cleanup for replica ``k``: cancel its waiting copies,
        fail over its unanswered entries at their original pins, and build
        typed ``replica_unavailable`` responses for any that cannot move —
        no admitted request is ever silently lost."""
        self._purged[k] = True
        out: List[Response] = []
        server = self.servers[k]
        for key in [key for key in list(self._rids) if key[0] == k]:
            entry = self._rids.pop(key)
            try:
                server.cancel(request_id=key[1])
            except Exception:  # noqa: BLE001 — dead replicas can't cancel
                pass
            if entry.answered or self._other_live(entry, key):
                continue
            nkey = self._failover(entry, exclude=k)
            if nkey is not None:
                self.n_failovers += 1
                self._note_event(
                    _errors.FAILED_OVER, k, to=nkey[0], tag=entry.tag
                )
                continue
            entry.answered = True
            self._resolve(entry)
            out.append(self._unavailable_response(entry, key[1]))
        return out

    def _hedge_scan(self) -> None:
        """Place one duplicate for each unanswered request aging on a slow
        replica. 'Slow' = SUSPECT, or flush EWMA above ``straggler_factor
        ×`` the best routable replica's. First ``ok`` wins; the loser is
        cancelled while waiting or dropped by id."""
        if self.hedge_ms is None:
            return
        now = time.perf_counter()
        thr_s = float(self.hedge_ms) / 1e3
        ewmas: Dict[int, float] = {}
        for k in self._routable():
            c = self.servers[k].continuous
            e = getattr(c, "flush_ewma_s", None) if c is not None else None
            if e is not None:
                ewmas[k] = e
        for entry in list({id(e): e for e in self._rids.values()}.values()):
            if entry.answered or entry.hedged or entry.failed_over:
                continue
            if now - entry.t_submit < thr_s:
                continue
            k = entry.replica
            slow = self.health[k].state == SUSPECT
            if not slow and k in ewmas:
                others = [v for j, v in ewmas.items() if j != k]
                slow = bool(others) and ewmas[k] > self.straggler_factor * min(
                    others
                )
            if not slow:
                continue
            pins = self._pins.get((entry.profile, entry.epoch), {})
            cands = [
                j for j in self._routable()
                if j != k and j in pins and self.health[j].state == HEALTHY
            ]
            if not cands:
                continue
            j = min(cands, key=lambda j: self.servers[j].load)
            remaining = (
                None
                if entry.deadline is None
                else max(entry.deadline - now, 1e-3)
            )
            try:
                rid = self.servers[j].submit(
                    entry.ts,
                    profile=entry.profile,
                    lixels=entry.lixels,
                    tag=entry.tag,
                    deadline_s=remaining,
                    pin=(entry.epoch, pins[j]),
                )
            except ServeRejected:
                continue
            entry.hedged = True
            entry.hedge_key = (j, rid)
            entry.keys.append((j, rid))
            self._rids[(j, rid)] = entry
            self.n_hedges += 1
            self._note_event("hedged", k, to=j, tag=entry.tag)

    # ---------------------------------------------------------- execution
    @property
    def n_queued(self) -> int:
        """Unanswered client requests + undelivered router-built responses
        — the load drivers loop until 0."""
        return self._n_outstanding + len(self._orphans)

    @property
    def has_ready_batch(self) -> bool:
        return any(self.servers[k].has_ready_batch for k in self._active())

    def _pump_order(self) -> List[int]:
        """Healthy before suspect, faster (lower flush EWMA) first — in a
        single-threaded loop this is what lets a hedged duplicate on a fast
        replica win the race against a stalled primary."""
        def key(k):
            h = self.health[k]
            c = self.servers[k].continuous
            e = getattr(c, "flush_ewma_s", None) if c is not None else None
            return (0 if h.state == HEALTHY else 1, e if e is not None else 0.0, k)

        return sorted(self._active(), key=key)

    def _flush_stuck(self) -> List[Response]:
        """Terminal fallback: unanswered entries with no pumpable replica
        left become typed ``replica_unavailable`` errors."""
        out: List[Response] = []
        for key in list(self._rids):
            entry = self._rids.pop(key, None)
            if entry is None or entry.answered:
                continue
            for k2 in entry.keys:
                self._rids.pop(k2, None)
            entry.answered = True
            self._resolve(entry)
            out.append(self._unavailable_response(entry, key[1]))
        return out

    def pump(self, *, force: bool = True) -> List[Response]:
        """One pump round across the fleet (``force=False``: only replicas
        holding a ready batch, one bounded cycle each; ``force=True``:
        drain until every outstanding request is answered). Unlike a single
        server's pump, responses are routed — failed-over copies replace
        their faulted originals, hedge losers are dropped — so the
        concatenation carries exactly one Response per admitted request."""
        out: List[Response] = list(self._orphans)
        self._orphans.clear()
        for k, h in enumerate(self.health):
            h.tick()
            if h.state != QUARANTINED:
                self._purged[k] = False
        self._hedge_scan()
        rounds = 0
        while True:
            rounds += 1
            progressed = False
            for k in self._pump_order():
                s = self.servers[k]
                if not (force or s.has_ready_batch):
                    continue
                try:
                    rs = s.pump(force=force)
                except Exception as e:  # noqa: BLE001 — pump contractually
                    # never raises; if it does, the replica is broken
                    if self.health[k].trip(needs_resync=True):
                        self.n_quarantines += 1
                    self._note_event("pump_fault", k, detail=repr(e))
                    rs = []
                if rs:
                    progressed = True
                for r in rs:
                    out.extend(self._route_response(k, r))
                self._harvest_signals(k)
                if self.health[k].state == QUARANTINED and not self._purged[k]:
                    out.extend(self._purge(k))
            if not force:
                break
            if self._n_outstanding == 0:
                break
            if not progressed or rounds > 2 * len(self.servers) + 4:
                out.extend(self._flush_stuck())
                break
        self.maybe_compact()
        if self.auto_resync and self._wal is not None:
            for k, h in enumerate(self.health):
                if h.state == QUARANTINED and h.needs_resync:
                    try:
                        self.resync(k)
                    except Exception as e:  # noqa: BLE001 — stay quarantined
                        self._note_event("resync_failed", k, detail=repr(e))
        return out

    def _harvest_signals(self, k: int) -> None:
        """Soft health signals from the per-server counters: watchdog
        stragglers and degradation-ladder trips mark SUSPECT (slow/degraded
        is not wrong — no failover, no trip)."""
        marks = self._marks
        st = self.servers[k].stats
        cur = (st.n_stragglers, st.n_degradations)
        prev = marks.get(k, (0, 0))
        if cur[0] > prev[0] or cur[1] > prev[1]:
            self.health[k].record_suspect()
            self._note_event(
                "suspect", k,
                stragglers=cur[0] - prev[0],
                degradations=cur[1] - prev[1],
            )
        marks[k] = cur

    # ----------------------------------------------------------- durability
    def attach_wal(self, wal) -> None:
        """Router-level WAL: every fleet mutation is logged ONCE here
        before any replica mutates. Attach before the first mutation —
        :meth:`resync` replays this log (past the latest checkpoint) to
        rebuild a quarantined replica, so the log must cover every mutation
        since the seed (or since :meth:`checkpoint`)."""
        self._wal = wal

    def checkpoint(
        self, ckpt_dir: Optional[str] = None, *, keep_last: int = 3
    ) -> int:
        """Fleet checkpoint: router-level seal (logged once), then persist
        ONE healthy replica's profiles at the WAL's sequence number —
        replicas are state-identical by the quorum invariant, so one copy
        is the fleet's copy — then rotate + prune the WAL."""
        ckpt_dir = ckpt_dir if ckpt_dir is not None else self._ckpt_dir
        if ckpt_dir is None:
            raise ValueError("checkpoint needs a ckpt_dir (none stored)")
        active = self._active()
        if not active:
            raise ReplicaUnavailable("no active replica to checkpoint from")
        self._ckpt_dir = ckpt_dir
        self.seal()
        seq = self._wal.last_seq if self._wal is not None else self._ckpt_step + 1
        # the donor's own seal() is a no-op (router sealed) and it has no
        # WAL attached, so this only writes the profile arrays + commit
        self.servers[active[0]].checkpoint(ckpt_dir, step=seq, keep_last=keep_last)
        self._ckpt_step = seq
        if self._wal is not None:
            self._wal.rotate()
            self._wal.prune(seq)
        return seq

    def restore(self, ckpt_dir=None, *, wal=None, attach: bool = True):
        """Cold-start recovery for the whole fleet: every replica restores
        the checkpoint and replays the shared WAL suffix (same records,
        same order = same ladder). Returns the first replica's aggregate
        RecoveryReport."""
        ckpt_dir = ckpt_dir if ckpt_dir is not None else self._ckpt_dir
        reps = [
            s.restore(ckpt_dir, wal=wal, attach=False) for s in self.servers
        ]
        if wal is not None and attach:
            self._wal = wal
        if ckpt_dir is not None:
            self._ckpt_dir = ckpt_dir
        for h in self.health:
            h.reset()
        lads = {self._ladder(k) for k in range(len(self.servers))}
        if len(lads) != 1:
            raise RuntimeError(
                f"fleet restore produced divergent epoch ladders: {sorted(lads)}"
            )
        return reps[0]

    def resync(self, k: int) -> dict:
        """Rebuild quarantined replica ``k`` from the latest checkpoint +
        WAL-suffix replay, verify it against a healthy replica (identical
        epoch ladder AND a ≤1e-12 spot query — replay correctness, not just
        record counts), warm it (no new library: they are per process), and readmit it
        HEALTHY. The old server object is discarded wholesale: a fresh
        engine carries no injected faults, no stale scheduler state, and no
        rid collisions (its ids restart, and the router's rid map was
        purged at quarantine)."""
        h = self.health[k]
        if self._wal is None:
            raise RuntimeError("resync requires a router-attached WAL")
        refs = [j for j in self._active() if j != k]
        if not refs:
            raise ReplicaUnavailable("no healthy reference replica for resync")
        ref = self.servers[refs[0]]
        h.state = RESYNCING
        t0 = time.perf_counter()
        try:
            spare = TNKDEServer(
                self._net, self._events, self._profiles_arg, **self._server_kw
            )
            rep = spare.restore(self._ckpt_dir, wal=self._wal, attach=False)
            mismatch = [
                name
                for name in ref.models
                if spare.models[name].epoch != ref.models[name].epoch
            ]
            if mismatch:
                raise RuntimeError(
                    f"resync({k}): epoch ladder mismatch after replay on "
                    f"profiles {mismatch}"
                )
            worst = 0.0
            for name, m in ref.models.items():
                if m.solution != "drfs":
                    continue
                tmax = float(m.stream_t_max)
                if not np.isfinite(tmax):
                    continue
                ts = (0.5 * tmax, tmax)
                a = np.asarray(spare.models[name].query(ts))
                b = np.asarray(m.query(ts))
                err = float(np.max(np.abs(a - b))) if a.size else 0.0
                scale = float(np.max(np.abs(b))) if b.size else 1.0
                if err > 1e-12 * max(1.0, scale):
                    raise RuntimeError(
                        f"resync({k}): spot query disagrees with healthy "
                        f"replica on {name!r} (max abs err {err:.3e})"
                    )
                worst = max(worst, err)
        except Exception:
            h.state = QUARANTINED
            h.needs_resync = True
            raise
        j0 = jit_entries()
        wrep = spare.warmup()
        j1 = jit_entries()
        self.servers[k] = spare
        for snaps in self._pins.values():
            snaps.pop(k, None)
        for key in [key for key in list(self._rids) if key[0] == k]:
            self._rids.pop(key)  # defensive; _purge ran at quarantine
        h.reset()
        self._purged[k] = False
        self.n_resyncs += 1
        report = {
            "replica": k,
            "restored_step": rep.restored_step,
            "n_records": rep.n_records,
            "n_events": rep.n_events,
            "replay_seconds": round(rep.replay_seconds, 4),
            "seconds": round(time.perf_counter() - t0, 4),
            "epoch_ok": True,
            "spot_max_abs_err": worst,
            "jit_entries_added": (j1 - j0) if (j0 >= 0 and j1 >= 0) else None,
            "warmup_seconds": wrep.get("seconds"),
        }
        self._note_event("resynced", k, **{
            "restored_step": report["restored_step"],
            "n_records": report["n_records"],
        })
        return report

    # ------------------------------------------------------------- warmup
    def warmup(self, **kw) -> dict:
        """Warm every active replica. The first replica pays the
        builds; the rest must load no library (one set per process) —
        asserted: the fleet-wide library-count delta after the
        first replica is 0. The report carries each replica's own
        (before, after) pair, so heterogeneous warmup is visible rather
        than hidden by reading ``before`` from one replica and ``after``
        from another."""
        t0 = time.perf_counter()
        reports = []
        pairs = []
        for k in self._active():
            rep = self.servers[k].warmup(**kw)
            reports.append(rep)
            pairs.append(
                (rep["jit_entries_before"], rep["jit_entries_after"])
            )
        added_after_first = 0
        if pairs and all(b >= 0 and a >= 0 for b, a in pairs):
            added_after_first = sum(a - b for b, a in pairs[1:])
            if added_after_first:
                raise RuntimeError(
                    f"replica warmup loaded {added_after_first} new CUDA "
                    "libraries after the first replica — the shared-library "
                    "invariant is broken (heterogeneous replica configs?)"
                )
        return {
            "replicas": reports,
            "window_classes": reports[0].get("window_classes") if reports else [],
            "jit_entries_before": pairs[0][0] if pairs else 0,
            "jit_entries_after": pairs[-1][1] if pairs else 0,
            "per_replica_jit_entries": [list(p) for p in pairs],
            "jit_entries_added_after_first": added_after_first,
            "seconds": round(time.perf_counter() - t0, 4),
        }

    # ------------------------------------------------------ observability
    def stats_json(self) -> dict:
        per = [s.stats_json() for s in self.servers]
        for p, h in zip(per, self.health):
            p["health"] = h.as_dict()
        agg = {
            "replicas": len(self.servers),
            "jit_entries": jit_entries(),
            "per_replica": per,
            "health": [h.state for h in self.health],
            "n_failovers": self.n_failovers,
            "n_hedges": self.n_hedges,
            "n_hedge_wins": self.n_hedge_wins,
            "n_hedge_superseded": self.n_hedge_superseded,
            "n_replica_unavailable": self.n_replica_unavailable,
            "n_quarantines": self.n_quarantines,
            "n_resyncs": self.n_resyncs,
            "ft_events": list(self.ft_events)[-32:],
        }
        for key in (
            "n_requests", "n_batches", "n_flushes", "n_errors", "n_shed",
            "n_expired", "n_hopeless_shed", "n_engine_faults", "n_retries",
            "n_degradations", "n_stragglers", "n_cancelled",
            "n_rows_computed", "n_windows_evaluated", "n_windows_requested",
        ):
            agg[key] = sum(p.get(key, 0) for p in per)
        occ = [p["batch_occupancy"] for p in per if p.get("n_flushes")]
        agg["batch_occupancy"] = round(float(np.mean(occ)), 4) if occ else 0.0
        return agg
