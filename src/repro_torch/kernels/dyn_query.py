"""DRFS tree phase of the ``executor='kernel'`` tier: two kernels.

* ``dyn_leaf_query`` — quantized mode over the leaf-prefix layout: per atom
  the difference of two per-edge leaf-prefix rows
  ``tab[hi·2+side] − tab[lo·2+side]``, contracted per window with the
  per-half query vectors ``qv_l/qv_r`` (q_s ⊗ q_t, s-major) and folded:
  ``Σ_k qv_l·Δ[k] + Σ_k qv_r·Δ[K+k]``. It replaces the TPU kernel
  ``repro.kernels.dyn_query.dyn_leaf_query_pallas``. With ``qv = q_s ⊗ q_t``
  that is ``fused_leaf``'s function in its association, so the flush reads
  the flat leaf table in place through ``csrc/fused_leaf.cu``
  (``ops.dyn_leaf_query_flat``, plain version
  ``fused_walk.fused_leaf_flat_ref``): no grouped copy of the table and no
  materialised query vectors. ``ops.dyn_leaf_query`` keeps the reference's
  grouped contract (``tab [G, R, W·2K]``, ``qv_l/qv_r [G, W, Q, K]``) on
  ``csrc/dyn_leaf_query.cu``; only the tests and ``chip_smoke.py``'s sweep
  of that contract call it.
* ``dyn_node_walk`` — exact mode over the complete-tree node values: the
  canonical ≤2-nodes-per-level climb of ``fused_walk`` with the fixed level
  layout ``offs[ℓ] = 2^(hq−ℓ) − 1`` (:func:`tree_offs`), ``hq + 1`` levels.
  It replaces ``repro.kernels.dyn_query.dyn_node_walk_pallas`` and launches
  the same CUDA source as ``fused_walk`` (``csrc/fused_walk.cu``) — there is
  no second copy of that kernel. The flush reads ``dyn_node_tables`` in
  place (``ops.dyn_node_walk_flat``, plain version
  ``fused_walk.fused_walk_flat_ref``); ``ops.dyn_node_walk`` keeps the
  grouped JAX contract on the same kernel.

This module holds the plain PyTorch versions of the grouped contracts
(:func:`dyn_leaf_query_ref`, :func:`dyn_node_walk_ref`) — what a CPU tensor
gets and what the kernels are compared with on the card — and the
``ctypes`` binding of ``csrc/dyn_leaf_query.cu``. The launching wrappers are
:func:`repro_torch.kernels.ops.dyn_leaf_query`, ``ops.dyn_leaf_query_flat``,
``ops.dyn_node_walk`` and ``ops.dyn_node_walk_flat``.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_walk import fused_walk_ref

__all__ = ["dyn_leaf_query_library", "dyn_leaf_query_ref", "dyn_node_walk_ref", "tree_offs"]


def tree_offs(hq: int) -> tuple:
    """Per-walk-level node-row offsets of the complete tree of height hq:
    walk level ℓ reads depth hq − ℓ, whose nodes start at 2^(hq−ℓ) − 1."""
    return tuple((1 << (hq - lev)) - 1 for lev in range(hq + 1))


def dyn_leaf_query_ref(
    tab: torch.Tensor,  # [G, R, W·2K] per-edge leaf-prefix rows, R = (nleaf+1)·2
    leaf_lo: torch.Tensor,  # [G, Q] fully-covered leaf range lo
    leaf_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q] event-feature side in {0, 1}
    qv_l: torch.Tensor,  # [G, W, Q, K] left-half query vectors
    qv_r: torch.Tensor,  # [G, W, Q, K] right-half query vectors
) -> torch.Tensor:
    """Quantized DRFS tree phase over the leaf-prefix layout: [G, W, Q],
    halves folded. Plain PyTorch; the torch transcription of
    ``repro.kernels.ref.dyn_leaf_query`` in the kernel's association: per
    half ``Σ_k qv·(hi[k] − lo[k])`` in k order, then left + right."""
    G, R, _ = tab.shape
    W, Q, K = qv_l.shape[1], qv_l.shape[2], qv_l.shape[3]
    gi = torch.arange(G, device=tab.device)[:, None]
    side = side.to(torch.int64)

    def rows(leaf):
        idx = (leaf.to(torch.int64) * 2 + side).clamp(0, R - 1)
        return tab[gi, idx].reshape(G, Q, W, 2 * K).permute(0, 2, 1, 3)  # [G, W, Q, 2K]

    diff = rows(leaf_hi) - rows(leaf_lo)
    vl = qv_l[..., 0] * diff[..., 0]
    vr = qv_r[..., 0] * diff[..., K]
    for k in range(1, K):
        vl = vl + qv_l[..., k] * diff[..., k]
        vr = vr + qv_r[..., k] * diff[..., K + k]
    return (vl + vr).contiguous()


def dyn_leaf_query_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/dyn_leaf_query.cu``, built at first use, with the
    argument types of ``dyn_leaf_query_f64`` set."""
    from ._build import load_library

    lib = load_library("dyn_leaf_query", verbose=verbose)
    fn = lib.dyn_leaf_query_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 6 + [p]
        fn.restype = i
    return lib


def dyn_node_walk_ref(
    nodeval: torch.Tensor,  # [G, (2^{hq+1}−1)·2, W·2k_s] per-edge node values
    r_lo: torch.Tensor,  # [G, Q] fully-covered leaf range lo
    r_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q]
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficient vectors
    *,
    hq: int,
) -> torch.Tensor:
    """Exact-mode DRFS tree phase: the canonical walk over q_t-folded node
    values of the complete tree, halves folded: [G, W, Q]. Plain PyTorch;
    the torch transcription of ``repro.kernels.ref.dyn_node_walk`` — the
    ``fused_walk`` climb with ``offs = tree_offs(hq)``."""
    return fused_walk_ref(nodeval, r_lo, r_hi, side, qs, offs=tree_offs(hq))
