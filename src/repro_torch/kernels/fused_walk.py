"""Fused packed-plan walk and fused leaf-prefix gather — ONE CUDA launch per
flush (DESIGN.md §12), reading the flat window tables in place.

The ``executor='fused'`` kernel of the port. Where the plain-torch ``packed``
executor runs the canonical climb as a Python loop of paired gathers (a few
device kernels per level), ``csrc/fused_walk.cu`` runs the ENTIRE walk — the
per-level node selection, the rank-state update and the q_s window
contraction — inside one launch. It reads the window table where
``torch_engine.packed_node_tables`` (RFS) or ``dyn_node_tables`` (DRFS exact)
left it: walk level ℓ of an atom on edge e reads row
``(lvl_base[ℓ, e] + node)·2 + side`` (:func:`fused_walk_flat_ref`), with
``lvl_base`` the packed forest's ``node_base_lvl`` or the complete tree's
``torch_engine.dyn_node_base``. The per-edge grouped layout of the JAX
contract (``[G, R2, W·2k_s]`` with static per-level offsets ``offs``:
:func:`fused_walk_ref`) is the special case ``lvl_base[ℓ, g] = g·R2/2 +
offs[ℓ]``, ``edges = arange(G)``, and the wrapper of that contract launches
the same kernel.

It replaces the TPU kernel ``repro.kernels.fused_walk.fused_walk_pallas``
(and ``repro.kernels.dyn_query.dyn_node_walk_pallas``); both plain versions
keep its arithmetic (left emit before right emit, levels ascending), so they
are held against the same oracle.

The second kernel, ``csrc/fused_leaf.cu``, is the DRFS quantized tree phase:
per atom the difference of two leaf-prefix rows, read in place from
``dyn_window_tables``' layout (row ``(edges[g]·(nleaf+1) + leaf)·2 + side``:
:func:`fused_leaf_flat_ref`; the grouped ``[G, R, W·2K]`` contract,
:func:`fused_leaf_ref`, is ``edges = arange(G)``), contracted per window
with ``q_s ⊗ q_t`` built in-kernel (s-major, left half + right half). It
replaces ``repro.kernels.fused_walk.fused_leaf_pallas``.

A pack's rows are located by a :class:`FlatIndex` (:func:`walk_index`,
:func:`leaf_index`), whose range is checked once, when the pack is built,
on host copies of its edges and node bases — never per launch and never on
the card, either of which would be a host sync.

Both take the window table in the table codec's storage dtype (the walk
float64, float32 or bfloat16, the leaf float64 or float32) and widen every
value they load to float64: the arithmetic is float64 whatever the table
stores, in the kernels and in their plain versions alike.

This module holds the plain PyTorch versions — what a CPU tensor gets and
what the kernels are compared with on the card — the index builders and the
``ctypes`` bindings of the compiled kernels. The launching wrappers, with
their checks and launch counts, are in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "FlatIndex",
    "fused_leaf_flat_ref",
    "fused_leaf_library",
    "fused_leaf_ref",
    "fused_walk_flat_ref",
    "fused_walk_library",
    "fused_walk_ref",
    "leaf_index",
    "walk_index",
    "MAX_LEVELS",
]

MAX_LEVELS = 32  # walk levels a launch may take (csrc/fused_walk.cu MAX_LEVELS)


class FlatIndex(NamedTuple):
    """Where one pack's rows lie in a flat window table, range-checked once
    when the pack is built (:func:`walk_index`, :func:`leaf_index`)."""

    edges: torch.Tensor  # [G] i64 edge of each group
    lvl_base: Optional[torch.Tensor]  # walk: [>= nlev, E] i64 node base per (level, edge)
    span: int  # walk: npad (level ℓ holds npad >> ℓ nodes); leaf: nleaf
    rows: int  # table rows the pack can read; the wrappers raise on a smaller table


def _host_copy(t: torch.Tensor, host, name: str) -> np.ndarray:
    """The host array a range check reads: ``host`` (the same values as
    ``t``), or ``t`` itself when it lies on the CPU."""
    if host is None:
        if t.device.type != "cpu":
            raise ValueError(f"{name} lies on {t.device}: pass {name}_host, its host copy, "
                             "so that the range check never waits for the card")
        return t.numpy()
    host = np.asarray(host)
    if host.shape != tuple(t.shape):
        raise ValueError(f"{name}_host has shape {host.shape}, {name} {tuple(t.shape)}")
    return host


def walk_index(lvl_base: torch.Tensor, edges: torch.Tensor, npad: int, *,
               lvl_base_host: Optional[np.ndarray] = None,
               edges_host: Optional[np.ndarray] = None) -> FlatIndex:
    """The :class:`FlatIndex` of a walk pack: ``npad.bit_length()`` levels,
    level ℓ of edge e the ``npad >> ℓ`` nodes from ``lvl_base[ℓ, e]``.
    Raises ``ValueError`` if an edge or a base is out of range. The check
    reads host arrays — ``lvl_base_host`` and ``edges_host``, required for
    tensors on the card — so it never waits for the card; the index holds
    the tensors. Call it when the pack is built."""
    npad = int(npad)
    nlev = npad.bit_length()
    if lvl_base.dim() != 2 or lvl_base.shape[0] < nlev or nlev > MAX_LEVELS:
        raise ValueError(f"lvl_base must be [>= {nlev}, E] for npad={npad} "
                         f"(at most {MAX_LEVELS} levels), got {tuple(lvl_base.shape)}")
    hb = _host_copy(lvl_base, lvl_base_host, "lvl_base")
    he = _host_copy(edges, edges_host, "edges")
    E = int(lvl_base.shape[1])
    rows = 0
    if he.size and nlev:
        emin, emax = int(he.min()), int(he.max())
        if emin < 0 or emax >= E:
            raise ValueError(f"edges out of range [0, {E}): [{emin}, {emax}]")
        base = hb[:nlev][:, he].astype(np.int64)  # [nlev, G]
        span = np.array([npad >> lev for lev in range(nlev)], np.int64)
        bmin, end = int(base.min()), int((base + span[:, None]).max())
        if bmin < 0:
            raise ValueError(f"lvl_base has a negative node base ({bmin})")
        rows = 2 * end
    return FlatIndex(edges, lvl_base, npad, rows)


def leaf_index(edges: torch.Tensor, nleaf: int, *,
               edges_host: Optional[np.ndarray] = None) -> FlatIndex:
    """The :class:`FlatIndex` of a leaf pack: ``(nleaf+1)·2`` rows per edge,
    edge e's block from row ``e·(nleaf+1)·2``. Raises ``ValueError`` on a
    negative edge. The check reads ``edges_host`` (required for edges on
    the card), so it never waits for the card. Call it when the pack is
    built."""
    nleaf = int(nleaf)
    he = _host_copy(edges, edges_host, "edges")
    rows = 0
    if he.size:
        emin, emax = int(he.min()), int(he.max())
        if emin < 0:
            raise ValueError(f"edges out of range: [{emin}, {emax}]")
        rows = (emax + 1) * (nleaf + 1) * 2
    return FlatIndex(edges, None, nleaf, rows)


def _climb(rows_at, l, r, nlev: int, WC: int):
    """The canonical ≤2-nodes-per-level climb of the plain versions:
    ``acc [G, Q, WC]`` float64, summed left emit before right emit, levels
    ascending, a level that emits nothing adding 0.0. ``rows_at(lev, node)``
    gathers the rows (any in-range row where nothing is emitted); a narrow
    table's rows are widened to float64 as they are gathered, as the kernel
    widens them in registers."""
    G, Q = l.shape
    acc = torch.zeros((G, Q, WC), dtype=torch.float64, device=l.device)
    for lev in range(nlev):
        emit_l = (l < r) & ((l & 1) == 1)
        acc = acc + torch.where(emit_l[..., None], rows_at(lev, l).to(torch.float64), 0.0)
        l = torch.where(emit_l, l + 1, l)
        emit_r = (l < r) & ((r & 1) == 1)
        acc = acc + torch.where(emit_r[..., None], rows_at(lev, r - 1).to(torch.float64), 0.0)
        r = torch.where(emit_r, r - 1, r)
        l, r = l >> 1, r >> 1
    return acc


def _contract_walk(acc, qs):
    """[G, Q, W]: per window ``Σ_s qs[s]·(acc[w, s] + acc[w, k_s + s])``,
    an unrolled multiply-add over k_s, s ascending — the kernel's order."""
    G, Q, WC = acc.shape
    ks = qs.shape[2]
    acc = acc.reshape(G, Q, WC // (2 * ks), 2, ks)
    out = qs[:, :, None, 0] * (acc[..., 0, 0] + acc[..., 1, 0])
    for s in range(1, ks):
        out = out + qs[:, :, None, s] * (acc[..., 0, s] + acc[..., 1, s])
    return out


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
    gi = torch.arange(G, device=nodeval.device)[:, None]
    side = side.to(torch.int64)

    def rows_at(lev, node):
        return nodeval[gi, ((offs[lev] + node) * 2 + side).clamp(0, R2 - 1)]

    acc = _climb(rows_at, r_lo.to(torch.int64), r_hi.to(torch.int64), len(offs), WC)
    return _contract_walk(acc, qs).permute(0, 2, 1).contiguous()  # [G, W, Q]


def fused_walk_flat_ref(
    table: torch.Tensor,  # [N2, W·2k_s] q_t-folded node rows, (node, side) per row
    index: FlatIndex,  # walk_index(lvl_base, edges, npad)
    r_lo: torch.Tensor,  # [G, Q] root rank interval lo
    r_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q] event-feature side in {0, 1}
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficient vectors
) -> torch.Tensor:
    """The walk of :func:`fused_walk_ref` read in place: level ℓ of atom
    (g, q) reads row ``(lvl_base[ℓ, edges[g]] + node)·2 + side`` (clamped to
    the table) of the flat table. [G, Q, W] — the layout the flush
    scatters, no permute. Plain PyTorch, the arithmetic of fused_walk_ref."""
    N2, WC = table.shape
    nlev = int(index.span).bit_length()
    base = index.lvl_base[:nlev][:, index.edges][..., None]  # [nlev, G, 1]
    side = side.to(torch.int64)

    def rows_at(lev, node):
        return table[((base[lev] + node) * 2 + side).clamp(0, N2 - 1)]

    acc = _climb(rows_at, r_lo.to(torch.int64), r_hi.to(torch.int64), nlev, WC)
    return _contract_walk(acc, qs)


def fused_walk_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/fused_walk.cu``, built at first use, with the
    argument types of its entries ``fused_walk_f64``, ``fused_walk_f32`` and
    ``fused_walk_bf16`` (one per table dtype, the same arguments) set
    (pointers and the stream are ``c_void_p``: ctypes would otherwise cut
    them to 32 bits)."""
    from ._build import load_library

    lib = load_library("fused_walk", verbose=verbose)
    for suffix in ("f64", "f32", "bf16"):
        fn = getattr(lib, f"fused_walk_{suffix}")
        if fn.argtypes is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [p, ll, p, ll, p, p, p, p, p, p, ll, ll, ll] + [i] * 9 + [p]
            fn.restype = i
    return lib


def _contract_leaf(diff, qs, qtl, qtr):
    """[G, Q, W]: ``Σ_k (q_s[s]·q_t[w, t])·diff[.., w, half, k]`` per half,
    k = s·k_t + t in order, then left + right — the kernel's association."""
    ks, kt = qs.shape[2], qtl.shape[1]
    vl = vr = None
    for s in range(ks):
        q_s = qs[:, :, None, s]  # [G, Q, 1]
        for t in range(kt):
            k = s * kt + t
            tl = (q_s * qtl[None, None, :, t]) * diff[..., 0, k]
            tr = (q_s * qtr[None, None, :, t]) * diff[..., 1, k]
            vl = tl if vl is None else vl + tl
            vr = tr if vr is None else vr + tr
    return vl + vr


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
    Q = qs.shape[1]
    W, kt = qtl.shape
    K = qs.shape[2] * kt
    gi = torch.arange(G, device=lcum.device)[:, None]
    side = side.to(torch.int64)

    def rows(leaf):  # widened to float64 as gathered (a narrow table)
        idx = (leaf.to(torch.int64) * 2 + side).clamp(0, R - 1)
        return lcum[gi, idx].to(torch.float64).reshape(G, Q, W, 2, K)

    diff = rows(leaf_hi) - rows(leaf_lo)
    return _contract_leaf(diff, qs, qtl, qtr).permute(0, 2, 1).contiguous()  # [G, W, Q]


def fused_leaf_flat_ref(
    lcum: torch.Tensor,  # [E·(nleaf+1)·2, W·2K] leaf-prefix rows (dyn_window_tables)
    index: FlatIndex,  # leaf_index(edges, nleaf)
    leaf_lo: torch.Tensor,  # [G, Q] fully-covered leaf range lo
    leaf_hi: torch.Tensor,  # [G, Q]
    side: torch.Tensor,  # [G, Q] event-feature side in {0, 1}
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficient vectors
    qtl: torch.Tensor,  # [W, k_t] left-half temporal vectors
    qtr: torch.Tensor,  # [W, k_t] right-half temporal vectors
) -> torch.Tensor:
    """The leaf phase of :func:`fused_leaf_ref` read in place: atom (g, q)
    reads rows ``edges[g]·R + clamp(leaf·2 + side, 0, R − 1)``,
    R = (nleaf+1)·2. [G, Q, W] — the layout the flush scatters. Plain
    PyTorch, the arithmetic of fused_leaf_ref."""
    G, Q = leaf_lo.shape
    W, kt = qtl.shape
    K = qs.shape[2] * kt
    R = (int(index.span) + 1) * 2
    base = index.edges[:, None] * R
    side = side.to(torch.int64)

    def rows(leaf):  # widened to float64 as gathered (a narrow table)
        idx = base + (leaf.to(torch.int64) * 2 + side).clamp(0, R - 1)
        return lcum[idx].to(torch.float64).reshape(G, Q, W, 2, K)

    return _contract_leaf(rows(leaf_hi) - rows(leaf_lo), qs, qtl, qtr)


def fused_leaf_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/fused_leaf.cu``, built at first use, with the
    argument types of its entries ``fused_leaf_f64`` and ``fused_leaf_f32``
    (one per table dtype, the same arguments) set."""
    from ._build import load_library

    lib = load_library("fused_leaf", verbose=verbose)
    for suffix in ("f64", "f32"):
        fn = getattr(lib, f"fused_leaf_{suffix}")
        if fn.argtypes is None:
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [p, ll, p, i, p, p, p, p, p, p, p, ll, ll, ll] + [i] * 6 + [p]
            fn.restype = i
    return lib
