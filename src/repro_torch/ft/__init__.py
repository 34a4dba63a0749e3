from .elastic import ElasticPlan, plan_degraded_mesh  # noqa: F401
from .faults import (  # noqa: F401
    KillPoint,
    crash_checkpoint_save,
    diverge_replica_mutation,
    fault_replica_queries,
    inject_query_faults,
    kill_replica,
    stall_replica,
    tear_wal_tail,
)
from .watchdog import StepWatchdog, PreemptionHandler  # noqa: F401
