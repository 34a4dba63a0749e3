"""Fused packed-plan walk and fused leaf-prefix gather — ONE CUDA launch per
flush (DESIGN.md §12).

The ``executor='fused'`` kernel of the port. Where the plain-torch ``packed``
executor runs the canonical climb as a Python loop of paired gathers (a few
device kernels per level), ``csrc/fused_walk.cu`` runs the ENTIRE walk — the
per-level node selection, the rank-state update and the q_s window
contraction — inside one launch over per-edge grouped node values. It serves
every level layout through the static ``offs`` tuple: the RFS packed forest
(per npad size class; level ℓ of an edge block holds ``npad >> ℓ`` nodes,
``offs[ℓ] = Σ_{j<ℓ} npad >> j``) and a complete tree
(``offs[ℓ] = 2^(hq−ℓ) − 1``).

It replaces the TPU kernel ``repro.kernels.fused_walk.fused_walk_pallas``
and keeps its contract (shapes in, ``[G, W, Q]`` out, left emit before right
emit, levels ascending), so both are held against the same oracle.

The second kernel, ``csrc/fused_leaf.cu``, is the DRFS quantized tree phase:
per atom the difference of two per-edge leaf-prefix rows
``lcum[hi·2+side] − lcum[lo·2+side]``, contracted per window with
``q_s ⊗ q_t`` built in-kernel (s-major, left half + right half). It
replaces ``repro.kernels.fused_walk.fused_leaf_pallas`` with the same
contract.

This module holds the plain PyTorch versions, :func:`fused_walk_ref` and
:func:`fused_leaf_ref` — what a CPU tensor gets and what the kernels are
compared with on the card — and the ``ctypes`` bindings of the compiled
kernels. The launching wrappers, with their checks and launch counts, are
:func:`repro_torch.kernels.ops.fused_walk` and ``ops.fused_leaf``.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "fused_leaf_library",
    "fused_leaf_ref",
    "fused_walk_library",
    "fused_walk_ref",
    "MAX_LEVELS",
]

MAX_LEVELS = 32  # the kernel's LevelOffsets capacity (csrc/fused_walk.cu)


def fused_walk_ref(
    nodeval: torch.Tensor,  # [G, R2, W·2k_s] per-edge q_t-folded node values
    r_lo: torch.Tensor,  # [G, Q] root rank interval lo
    r_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q] event-feature side in {0, 1}
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficient vectors
    *,
    offs: tuple,  # per-walk-level node-row offsets within the edge block
) -> torch.Tensor:
    """Canonical walk + contraction over an arbitrary level layout:
    [G, W, Q], halves folded per window center. Plain PyTorch; the torch
    transcription of ``repro.kernels.ref.fused_walk``."""
    G, R2, WC = nodeval.shape
    Q, ks = qs.shape[1], qs.shape[2]
    W = WC // (2 * ks)
    gi = torch.arange(G, device=nodeval.device)[:, None]
    l = r_lo.to(torch.int64)
    r = r_hi.to(torch.int64)
    side = side.to(torch.int64)
    acc = torch.zeros((G, Q, WC), dtype=nodeval.dtype, device=nodeval.device)
    for off in offs:
        emit_l = (l < r) & ((l & 1) == 1)
        rows = nodeval[gi, ((off + l) * 2 + side).clamp(0, R2 - 1)]
        acc = acc + torch.where(emit_l[..., None], rows, 0.0)
        l = torch.where(emit_l, l + 1, l)
        emit_r = (l < r) & ((r & 1) == 1)
        rows = nodeval[gi, ((off + r - 1) * 2 + side).clamp(0, R2 - 1)]
        acc = acc + torch.where(emit_r[..., None], rows, 0.0)
        r = torch.where(emit_r, r - 1, r)
        l, r = l >> 1, r >> 1
    acc = acc.reshape(G, Q, W, 2, ks)
    # unrolled multiply-add over k_s, s ascending — the kernel's order
    out = qs[:, :, None, 0] * (acc[..., 0, 0] + acc[..., 1, 0])
    for s in range(1, ks):
        out = out + qs[:, :, None, s] * (acc[..., 0, s] + acc[..., 1, s])
    return out.permute(0, 2, 1).contiguous()  # [G, W, Q]


def fused_walk_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/fused_walk.cu``, built at first use, with the
    argument types of ``fused_walk_f64`` set (pointers and the stream are
    ``c_void_p``: ctypes would otherwise cut them to 32 bits)."""
    from ._build import load_library

    lib = load_library("fused_walk", verbose=verbose)
    fn = lib.fused_walk_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.POINTER(i), i, i, p]
        fn.restype = i
    return lib


def fused_leaf_ref(
    lcum: torch.Tensor,  # [G, R, W·2K] per-edge leaf-prefix rows, R = (nleaf+1)·2
    leaf_lo: torch.Tensor,  # [G, Q] fully-covered leaf range lo
    leaf_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q] event-feature side in {0, 1}
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficient vectors
    qtl: torch.Tensor,  # [W, k_t] left-half temporal vectors
    qtr: torch.Tensor,  # [W, k_t] right-half temporal vectors
) -> torch.Tensor:
    """Quantized DRFS tree phase with the q_s ⊗ q_t contraction fused in:
    [G, W, Q], halves folded. Plain PyTorch; the torch transcription of
    ``repro.kernels.ref.fused_leaf``, in the kernel's association: for
    k = s·k_t + t in order, ``(q_s[s]·q_t[w, t])·(hi[k] − lo[k])`` summed per
    half, then left + right."""
    G, R, _ = lcum.shape
    Q, ks = qs.shape[1], qs.shape[2]
    W, kt = qtl.shape
    K = ks * kt
    gi = torch.arange(G, device=lcum.device)[:, None]
    side = side.to(torch.int64)

    def rows(leaf):
        idx = (leaf.to(torch.int64) * 2 + side).clamp(0, R - 1)
        return lcum[gi, idx].reshape(G, Q, W, 2, K)

    diff = rows(leaf_hi) - rows(leaf_lo)
    vl = vr = None
    for s in range(ks):
        q_s = qs[:, :, None, s]  # [G, Q, 1]
        for t in range(kt):
            k = s * kt + t
            tl = (q_s * qtl[None, None, :, t]) * diff[..., 0, k]
            tr = (q_s * qtr[None, None, :, t]) * diff[..., 1, k]
            vl = tl if vl is None else vl + tl
            vr = tr if vr is None else vr + tr
    return (vl + vr).permute(0, 2, 1).contiguous()  # [G, W, Q]


def fused_leaf_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/fused_leaf.cu``, built at first use, with the
    argument types of ``fused_leaf_f64`` set."""
    from ._build import load_library

    lib = load_library("fused_leaf", verbose=verbose)
    fn = lib.fused_leaf_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
    return lib
