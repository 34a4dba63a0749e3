"""repro_torch.serve — snapshot-isolated, batched TN-KDE query serving on
the PyTorch port (the reference package's ``repro.serve``, same surface).

Continuous slot-scheduled batching with double-buffered dispatch
(`continuous`, the default core), the barrier micro-batcher (`scheduler`),
MVCC revision pinning over the streaming DRFS index (`drfs.DrfsSnapshot`
threaded through `TNKDE.dispatch(at=...)`), an epoch-keyed result cache
(`cache`), the `TNKDEServer` control loop (`server`), the multi-replica
epoch-consistent `ReplicaRouter` (`router`), and the load-generation /
latency harness (`loadgen`, closed- and open-loop) that
`repro_torch.launch.serve` drives.
"""
from .cache import ResultCache
from .continuous import ContinuousCore, SlotScheduler
from .errors import (
    DeadlineExceeded,
    EngineFaultError,
    QueueFull,
    ReplicaUnavailable,
    ServeError,
    ServeRejected,
)
from .loadgen import (
    InsertItem,
    LoadReport,
    QueryItem,
    make_arrivals,
    make_request_mix,
    run_open_loop,
    run_sequential,
    run_server,
    summarize,
)
from .router import (
    HEALTHY,
    QUARANTINED,
    RESYNCING,
    SUSPECT,
    ReplicaHealth,
    ReplicaRouter,
)
from .scheduler import MicroBatch, MicroBatcher, Request, window_class
from .server import (
    ProfileConfig,
    RequestStats,
    Response,
    ServerStats,
    TNKDEServer,
    jit_entries,
)

__all__ = [
    "ContinuousCore",
    "DeadlineExceeded",
    "EngineFaultError",
    "HEALTHY",
    "InsertItem",
    "LoadReport",
    "MicroBatch",
    "MicroBatcher",
    "ProfileConfig",
    "QUARANTINED",
    "QueryItem",
    "QueueFull",
    "RESYNCING",
    "ReplicaHealth",
    "ReplicaRouter",
    "ReplicaUnavailable",
    "SUSPECT",
    "Request",
    "RequestStats",
    "ResultCache",
    "Response",
    "ServeError",
    "ServeRejected",
    "ServerStats",
    "SlotScheduler",
    "TNKDEServer",
    "jit_entries",
    "make_arrivals",
    "make_request_mix",
    "run_open_loop",
    "run_sequential",
    "run_server",
    "summarize",
    "window_class",
]
