"""Deterministic fault injection (DESIGN.md §8).

The injectors emulate, without any real process mayhem, exactly the failure
modes the durability + serving layers claim to survive:

* :func:`crash_checkpoint_save` — kill the process at a *named stage* of the
  checkpoint write path (before the Nth array, before meta.json, before or
  after COMMIT-in-staging). Drives the "a save killed anywhere leaves
  ``latest_step`` at the previous commit" property test.
* :func:`tear_wal_tail` — chop or scribble bytes at the tail of the last WAL
  segment, the footprint of a crash mid-append.
* :func:`inject_query_faults` — wrap a model's ``dispatch`` (the seam both
  ``query`` and the continuous serve core route through) so the Nth engine
  pass raises (:class:`~repro_torch.serve.errors.EngineFaultError`, optionally
  transient) and/or stalls for ``slow_s`` — drives the serve tier's retry,
  degradation-ladder and watchdog paths.

Everything is plain-Python and in-process so the property tests stay fast;
the *actual* process-death path is covered by the subprocess crash smoke in
``tests/test_torch_recovery.py`` (``os._exit`` mid-stream, then recover).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterable, Optional, Set

__all__ = [
    "KillPoint",
    "crash_checkpoint_save",
    "diverge_replica_mutation",
    "fault_replica_queries",
    "inject_query_faults",
    "kill_replica",
    "stall_replica",
    "tear_wal_tail",
]


class KillPoint(BaseException):
    """Raised by the checkpoint crash hook to emulate sudden process death.

    Deliberately a ``BaseException``: the code under test must not be able
    to swallow it with a routine ``except Exception`` — a real SIGKILL
    wouldn't be catchable either.
    """

    def __init__(self, stage: str, detail: int = 0):
        super().__init__(f"injected kill at checkpoint stage {stage!r}[{detail}]")
        self.stage = stage
        self.detail = detail


@contextlib.contextmanager
def crash_checkpoint_save(stage: str, detail: int = 0):
    """Arm the ``repro_torch.ckpt`` crash seam: the next save raises
    :class:`KillPoint` when it reaches ``stage`` (``'array'``/``'meta'``/
    ``'commit'``/``'replace'``; ``detail`` selects the array index)."""
    from repro_torch.ckpt import checkpoint as _ck

    def hook(s: str, d: int = 0) -> None:
        if s == stage and d == detail:
            raise KillPoint(s, d)

    prev = _ck._CRASH_HOOK
    _ck._CRASH_HOOK = hook
    try:
        yield
    finally:
        _ck._CRASH_HOOK = prev


def tear_wal_tail(wal_dir: str, nbytes: int = 16, *, scribble: bool = False) -> str:
    """Damage the tail of the LAST segment — what a crash mid-append leaves.

    ``scribble=False`` truncates ``nbytes`` off the end (short final
    record); ``scribble=True`` overwrites the last ``nbytes`` with garbage
    (bad CRC). Returns the damaged segment's path.
    """
    segs = sorted(
        n for n in os.listdir(wal_dir) if n.startswith("seg_") and n.endswith(".wal")
    )
    if not segs:
        raise FileNotFoundError(f"no WAL segments under {wal_dir}")
    path = os.path.join(wal_dir, segs[-1])
    size = os.path.getsize(path)
    n = min(int(nbytes), size)
    with open(path, "rb+") as f:
        if scribble:
            f.seek(size - n)
            f.write(b"\xde\xad" * ((n + 1) // 2))
        else:
            f.truncate(size - n)
    return path


def inject_query_faults(
    model,
    *,
    fail_on: Iterable[int] = (),
    transient: bool = False,
    slow_on: Iterable[int] = (),
    slow_s: float = 0.0,
    exc_factory: Optional[Callable[[], Exception]] = None,
) -> Callable[[], int]:
    """Wrap ``model.dispatch`` (instance attribute shadowing the bound
    method) so call number ``i`` (0-based) raises when ``i in fail_on`` and
    sleeps ``slow_s`` first when ``i in slow_on``. ``dispatch`` is the
    injection seam because BOTH execution paths route through it: the
    synchronous ``model.query`` is ``dispatch().result()`` and resolves the
    instance attribute, and the continuous serve core calls ``dispatch``
    directly for its double-buffered flushes. Counts every call — including
    the serve tier's retries, which is how the retry tests observe them.
    Returns a zero-arg callable reporting the call count so far.

    Survives ``TNKDE.degrade``: the wrapper holds the bound method, whose
    ``self`` is the model, and the model's engine is re-resolved per call —
    after a ladder trip the same wrapper drives the degraded engine.
    """
    fail_set: Set[int] = set(int(i) for i in fail_on)
    slow_set: Set[int] = set(int(i) for i in slow_on)
    inner = model.dispatch  # bound method (class attribute lookup)
    calls = [0]

    def dispatch(ts, **kw):
        i = calls[0]
        calls[0] += 1
        if i in slow_set and slow_s > 0:
            time.sleep(slow_s)
        if i in fail_set:
            if exc_factory is not None:
                raise exc_factory()
            from repro_torch.serve.errors import EngineFaultError

            raise EngineFaultError(
                f"injected engine fault on call {i}", transient=transient
            )
        return inner(ts, **kw)

    model.dispatch = dispatch
    return lambda: calls[0]


# --------------------------------------------------------------------------
# Replica-targeted injectors (DESIGN.md §11). Each takes a TNKDEServer — one
# replica of a ReplicaRouter fleet — and emulates a whole-replica failure
# mode in-process. The router must keep the fleet serving: failover for
# queries, quarantine for the replica, resync to readmit it.
# --------------------------------------------------------------------------


def kill_replica(server) -> Callable[[], int]:
    """Emulate sudden replica death: every subsequent engine pass AND every
    mutation on ``server`` raises a non-transient
    :class:`~repro_torch.serve.errors.EngineFaultError`. Admission still succeeds
    (the connection is accepted, then the backend is gone) — which is
    exactly the window the router's failover path must cover. Returns a
    zero-arg callable reporting how many calls hit the dead replica."""
    from repro_torch.serve.errors import EngineFaultError

    calls = [0]

    def dead(*a, **kw):
        calls[0] += 1
        raise EngineFaultError("replica is dead", transient=False)

    for model in server.models.values():
        model.dispatch = dead
    server.insert = dead
    server.seal = dead
    server.compact = dead
    return lambda: calls[0]


def fault_replica_queries(
    server,
    *,
    fail_first: Optional[int] = None,
    transient: bool = False,
) -> Callable[[], int]:
    """Make every engine pass on ``server`` raise — across ALL profiles,
    sharing ONE call counter (unlike :func:`inject_query_faults`, which is
    per-model). ``fail_first=None`` faults forever (a sick replica);
    ``fail_first=n`` faults only the first *n* passes and then heals — the
    shape that exercises the breaker's half-open probe path. Mutations are
    untouched: the replica's state stays correct, so quarantine must NOT
    set ``needs_resync``. Returns the shared call counter."""
    from repro_torch.serve.errors import EngineFaultError

    calls = [0]

    def wrap(model):
        inner = model.dispatch  # bound method

        def dispatch(ts, **kw):
            i = calls[0]
            calls[0] += 1
            if fail_first is None or i < int(fail_first):
                raise EngineFaultError(
                    f"injected replica query fault on call {i}",
                    transient=transient,
                )
            return inner(ts, **kw)

        model.dispatch = dispatch

    for model in server.models.values():
        wrap(model)
    return lambda: calls[0]


def stall_replica(server, slow_s: float) -> Callable[[], int]:
    """Make every engine pass on ``server`` sleep ``slow_s`` first — a
    straggler replica (overcommitted host, thermal throttle). Answers stay
    correct, just late: the router's hedging path should win the race with
    a duplicate on a healthy replica. Returns the stalled-call counter."""
    calls = [0]

    def wrap(model):
        inner = model.dispatch

        def dispatch(ts, **kw):
            calls[0] += 1
            time.sleep(slow_s)
            return inner(ts, **kw)

        model.dispatch = dispatch

    for model in server.models.values():
        wrap(model)
    return lambda: calls[0]


def diverge_replica_mutation(server, *, once: bool = True) -> Callable[[], int]:
    """Make the NEXT ``server.insert`` additionally seal the streaming
    indexes after the real insert — the insert *succeeds*, no exception,
    but the replica's epoch ladder silently walks ahead of its peers
    (pend_revision collapses into revision). This is the failure mode the
    router's post-mutation quorum exists for: no error to catch, only a
    ladder mismatch to detect, and the loser's state is WRONG — quarantine
    must set ``needs_resync`` (half-open probes cannot readmit it).
    ``once=False`` diverges every insert. Returns the diverged-call count."""
    inner = server.insert  # bound method
    calls = [0]

    def insert(events):
        inner(events)
        if once and calls[0] >= 1:
            return
        calls[0] += 1
        for model in server.models.values():
            if model.solution == "drfs":
                model.index.seal()

    server.insert = insert
    return lambda: calls[0]
