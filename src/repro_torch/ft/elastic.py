"""Elastic re-meshing: restart a job on fewer (or more) pods/chips.

On a fleet, node failure is routine; the framework's contract is:
  1. the watchdog (ft.watchdog) detects the stall / the scheduler reports
     the dead slice;
  2. the launcher computes a *degraded mesh plan* — the largest production
     mesh shape that fits the surviving chips while keeping the model axis
     intact (TP degree is fixed by the layer shapes; data/pod shrink);
  3. the last committed checkpoint is restored onto the new mesh (the
     checkpoint layout is sharding-agnostic: whole .npy leaves);
  4. global batch is preserved via gradient accumulation (micro-steps =
     old_data_parallel / new_data_parallel), so the training trajectory is
     unchanged up to data order within the step.

Pure planning logic — unit-tested, no cluster API dependencies. A copy of the
reference package's module: on one card it has no caller; it keeps ``ft/``
whole for multi-card serving."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ElasticPlan", "plan_degraded_mesh"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grad_accum: int  # micro-steps to preserve the global batch
    dropped_chips: int
    notes: str


def plan_degraded_mesh(
    alive_chips: int,
    *,
    model_parallel: int = 16,
    old_data_parallel: int = 16,
    old_pods: int = 2,
    pod_size: int = 256,
) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits `alive_chips`.

    The model axis is non-negotiable (weights are TP-sharded model_parallel
    ways); whole pods are dropped first (slice-granular failures), then data
    rows within the last pod.
    """
    if alive_chips < model_parallel:
        raise ValueError("fewer chips than the TP degree — cannot restart")
    full_pods = min(alive_chips // pod_size, old_pods)
    rem = alive_chips - full_pods * pod_size if full_pods < old_pods else 0
    extra_rows = rem // model_parallel
    if full_pods >= 1 and extra_rows == 0:
        shape = (full_pods, old_data_parallel, model_parallel)
        names = ("pod", "data", "model")
        dp = full_pods * old_data_parallel
    elif full_pods >= 1:
        # heterogeneous leftover rows cannot join an SPMD mesh; park them
        shape = (full_pods, old_data_parallel, model_parallel)
        names = ("pod", "data", "model")
        dp = full_pods * old_data_parallel
    else:
        rows = alive_chips // model_parallel
        shape = (rows, model_parallel)
        names = ("data", "model")
        dp = rows
    old_dp = old_pods * old_data_parallel
    accum = max(1, -(-old_dp // dp))
    used = 1
    for s in shape:
        used *= s
    return ElasticPlan(
        mesh_shape=shape,
        axis_names=names,
        grad_accum=accum,
        dropped_chips=alive_chips - used,
        notes=(
            f"keep TP={model_parallel}; data-parallel {old_dp}->{dp}; "
            f"grad_accum={accum} preserves the global batch"
        ),
    )
