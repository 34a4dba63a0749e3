"""Typed serving failures (DESIGN.md §8).

Two failure channels, deliberately distinct:

* **admission rejections** are *exceptions* (:class:`ServeRejected`
  subclasses) raised by ``TNKDEServer.submit`` — the request never entered
  a queue, so there is no Response to carry the error. Load shedding
  (:class:`QueueFull`) is the bounded-queue backpressure signal.
* **post-admission failures** are *error Responses*: every admitted request
  gets exactly one Response, ``ok=False`` ones carrying a
  :class:`ServeError` (deadline expiry, an engine fault after retry, an
  internal pump fault). The pump itself never raises — a fault in one
  micro-batch must not take down the serving loop or the other profiles.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "DeadlineExceeded",
    "EngineFaultError",
    "QueueFull",
    "ReplicaUnavailable",
    "ServeError",
    "ServeRejected",
]

# error codes carried by ServeError (stable strings; clients switch on them)
DEADLINE_EXCEEDED = "deadline_exceeded"
# SLO admission control (DESIGN.md §10): the request was shed *before*
# spending a slot because its deadline cannot be met — the flush-time EWMA
# says service would finish past it. Retryable with a later deadline.
DEADLINE_HOPELESS = "deadline_hopeless"
ENGINE_FAULT = "engine_fault"
INTERNAL = "internal"
# fleet fault tolerance (DESIGN.md §11): a request could not be placed on —
# or failed over to — any HEALTHY/SUSPECT replica. Retryable: quarantined
# replicas re-open via half-open probes or resync().
REPLICA_UNAVAILABLE = "replica_unavailable"
# accounting codes for the router's ft_events journal (never client-facing
# on a delivered Response): the faulted primary whose answer was replaced by
# an exact failover copy, and the slower copy of a hedged pair.
FAILED_OVER = "failed_over"
HEDGE_SUPERSEDED = "hedge_superseded"


@dataclasses.dataclass
class ServeError:
    """The error payload of an ``ok=False`` Response."""

    code: str  # one of the module-level code constants
    message: str
    retryable: bool = False  # a resubmit may succeed (transient fault, shed)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServeRejected(RuntimeError):
    """Base of admission-time rejections: the request was NOT queued."""

    code = INTERNAL
    retryable = False


class QueueFull(ServeRejected):
    """Load shed: the scheduler's bounded queue is at ``max_queued``."""

    code = "queue_full"
    retryable = True


class DeadlineExceeded(ServeRejected):
    """The request's deadline was already in the past at admission."""

    code = DEADLINE_EXCEEDED
    retryable = False


class ReplicaUnavailable(ServeRejected):
    """No HEALTHY or SUSPECT replica can take the request (whole fleet
    quarantined). Admission-time only; post-admission the same condition is
    delivered as an ``ok=False`` Response with code REPLICA_UNAVAILABLE."""

    code = REPLICA_UNAVAILABLE
    retryable = True


class EngineFaultError(RuntimeError):
    """Raised by fault injectors (repro_torch.ft.faults) to emulate an engine
    failure; ``transient=True`` models a fault a single retry clears."""

    def __init__(self, message: str = "injected engine fault", *, transient: bool = False):
        super().__init__(message)
        self.transient = transient
