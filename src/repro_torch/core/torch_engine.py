"""PyTorch port of the packed-plan RFS query engine (``repro.core.jax_engine``).

Same algorithm as rfs.RangeForest, expressed as plain functions on torch
tensors over the flat position-major tables, float64 throughout. No jit:
PyTorch runs eagerly, so the fixed-trip loops of the reference are Python
loops of branch-free tensor steps.

Window batching (the paper's multiple temporal KDE scenario, §8.2): one call
answers all W query windows. Each window center t contributes two *half
windows* ([t-b_t, t] and (t, t+b_t], the "doubled aggregations" of §3.3), so
the :class:`WindowBatch` has Wh = 2·W rows. Everything that does not depend
on the window — the atom's three position bounds, its spatial coefficient
vector q_s, its edge block — is stored once per atom.

The **packed-plan** executor (:class:`PackedForest` / :func:`packed_walk`,
DESIGN.md §7): a position-major transpose of the merge tree whose per-node
window values are q_t-folded once per (snapshot, window batch) at node-count
scale (:func:`packed_node_tables`), leaving the per-atom walk one paired
gather per level with window-independent [M] state. The ``fused`` executor
replaces that walk with one CUDA launch (``repro_torch.kernels.fused_walk``)
over the same tables.

Differences from the reference that matter to a reader:

* out-of-range gathers raise in torch where jnp clamps, so every
  ``clamp_min(i − 1, 0)`` / ``where(lo < hi, mid, 0)`` / ``clamp(…, 0, R2−1)``
  of the reference is kept;
* index state is int64 (what torch indexing takes natively); the rank
  intervals handed to the kernel are int32, converted once at pack time;
* contractions over the small feature axes are unrolled multiply-adds, not
  ``einsum``/``matmul``: elementwise kernels do the same arithmetic for
  every output element, so duplicate window centers come out bitwise
  identical on the GPU as well.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "FlatAtoms",
    "PackedForest",
    "WindowBatch",
    "eval_atoms_packed",
    "packed_forest_from_numpy",
    "packed_node_tables",
    "packed_root_ranks",
    "packed_walk",
]

# node rows folded per step of packed_node_tables: bounds the transient
# [3, W, chunk, 4, K] prefix gather (the level-0 fold of a full-size forest
# would otherwise materialise several GB at once)
FOLD_CHUNK = 1 << 18


class FlatAtoms(NamedTuple):
    """Flattened window-INDEPENDENT atoms (see plan.AtomSet)."""

    lixel: torch.Tensor  # [M] i64 output index
    edge: torch.Tensor  # [M] i64
    side_feat: torch.Tensor  # [M] i32 in {0, 1}: event features ψ_c / ψ_d
    qs: torch.Tensor  # [M, k_s] spatial coefficient vector
    pos_hi: torch.Tensor  # [M]
    pos_lo1: torch.Tensor  # [M]
    lo1_right: torch.Tensor  # [M] bool
    pos_lo2: torch.Tensor  # [M]
    valid: torch.Tensor  # [M] bool (padding mask)


class PackedForest(NamedTuple):
    """Position-major merge-tree tables — the packed-plan layout (DESIGN §7).

    Level ℓ buckets 2^ℓ consecutive POSITION-ranks of an edge; inside a
    bucket events are TIME-sorted and carry inclusive prefix sums of the raw
    moment block Φ. The per-query binary searches therefore run on the
    per-node axis: the time boundaries of a window batch are resolved once
    per (boundary, window, node) in :func:`packed_node_tables` — O(nodes)
    work, already contracted with q_t — and an atom only converts its three
    position bounds to a rank interval at the root
    (:func:`packed_root_ranks`, window-independent, cached in the plan) and
    walks the canonical ≤2-nodes-per-level decomposition gathering finished
    per-node values (:func:`packed_walk`, or the fused kernel).

    ``node_base[e, lev]`` maps (edge, walk level, bucket) to the flat node
    index of the value tables: id = node_base[e, lev] + bucket.
    """

    pm_pos: torch.Tensor  # [P] per-edge position-sorted values (+inf pad)
    pos_base: torch.Tensor  # [E] i64 flat offset of each edge's pm_pos block
    pm_time: torch.Tensor  # [T] level-major bucket tables, time-sorted
    pm_cum: torch.Tensor  # [T, 4, K] inclusive prefix moments (bucket-local)
    edge_base: torch.Tensor  # [E] i64 flat offset of each edge's level block
    n_pad: torch.Tensor  # [E] i64 padded event count (power of two; 0 = empty)
    n_lev: torch.Tensor  # [E] i64 level count
    node_base: torch.Tensor  # [E, Lmax] i64 flat node-id base per walk level


class WindowBatch(NamedTuple):
    """Per-half-window query tables: Wh = 2 · n_window_centers entries."""

    t_lo: torch.Tensor  # [Wh] window-half lower time bound
    t_hi: torch.Tensor  # [Wh] upper bound (always inclusive)
    lo_right: torch.Tensor  # [Wh] bool: lower bound exclusive? (right halves)
    half: torch.Tensor  # [Wh] i32 temporal orientation (0 = left, 1 = right)
    qt: torch.Tensor  # [Wh, k_t] temporal coefficient vector


def packed_forest_from_numpy(host: dict, device):
    """Upload ``build_packed_host_tables`` output: ``(PackedForest, meta)``.

    ``host`` is exactly the dict of numpy arrays that function returns
    (``pm_pos, pos_base, pm_time, pm_cum, edge_base, n_pad, n_lev,
    node_base, node_starts, n_nodes, steps_per_level``) — from this package
    or from the reference's ``repro.core.rfs.build_packed_host_tables``, so
    index state built there can be served here. Float tables become float64
    tensors, index tables int64. ``meta`` carries the per-level node-start
    tensors, the [Lmax, E] walk-level node bases, the per-level search trip
    counts and the node count.
    """
    dev = torch.device(device)

    def f64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64), device=dev)

    def i64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64), device=dev)

    pf = PackedForest(
        pm_pos=f64(host["pm_pos"]),
        pos_base=i64(host["pos_base"]),
        pm_time=f64(host["pm_time"]),
        pm_cum=f64(host["pm_cum"]),
        edge_base=i64(host["edge_base"]),
        n_pad=i64(host["n_pad"]),
        n_lev=i64(host["n_lev"]),
        node_base=i64(host["node_base"]),
    )
    meta = dict(
        node_starts=tuple(i64(s) for s in host["node_starts"]),
        # walk-level -> node base, transposed for per-level row indexing
        node_base_lvl=i64(np.asarray(host["node_base"]).T),
        steps_per_level=tuple(int(s) for s in host["steps_per_level"]),
        n_nodes=int(host["n_nodes"]),
    )
    return pf, meta


def _seg_search(vals, seg_lo, seg_hi, q, right, steps: int):
    """Branch-free binary search of q within vals[seg_lo:seg_hi], batched
    over arbitrary leading dims (all args broadcast to a common shape).
    ``steps`` fixed trips; a finished lane (lo == hi) reads vals[0] and
    keeps its state, so ±inf pads search to the segment end."""
    lo, hi, q, right = torch.broadcast_tensors(seg_lo, seg_hi, q, right)
    lo, hi = lo.clone(), hi.clone()
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    for _ in range(steps):
        live = lo < hi
        mid = (lo + hi) >> 1
        v = vals[torch.where(live, mid, zero)]
        go = torch.where(right, v <= q, v < q) & live
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go | ~live, hi, mid)
    return lo


def _dyn_boundaries(wb: WindowBatch):
    """(t_b [3, W], right_b [3, W]): the (lo, mid, hi) time boundaries per
    window center — mid is shared by both halves, so W centers carry 3 rank
    boundaries instead of 4 (the paired ``make_window_batch`` layout)."""
    W = wb.t_lo.shape[0] // 2
    t_b = torch.stack([wb.t_lo[0::2], wb.t_hi[0::2], wb.t_hi[1::2]])
    right_b = torch.zeros((3, W), dtype=torch.bool, device=t_b.device)
    right_b[1:] = True
    return t_b, right_b


def packed_root_ranks(pf: PackedForest, atoms: FlatAtoms, *, search_steps: int):
    """Window-independent position-rank interval [r_lo, r_hi) per atom: [M] i32.

    The packed executor's only per-atom searches: the three position bounds
    are resolved against the edge's position-sorted root row in ONE batched
    search (stacked bound axis) and collapse to two ranks. Cached inside the
    plan's atom blocks, so steady-state flushes pay no searches at all.
    Padded atoms (pos_hi = −inf, pos_lo* = +inf) come out with r_lo == r_hi.
    """
    M = atoms.edge.shape[0]
    dev = atoms.edge.device
    eid = atoms.edge
    s_lo = pf.pos_base[eid]
    s_hi = s_lo + pf.n_pad[eid]
    q = torch.stack([atoms.pos_hi, atoms.pos_lo1, atoms.pos_lo2])
    right = torch.stack(
        [
            torch.ones(M, dtype=torch.bool, device=dev),
            atoms.lo1_right,
            torch.zeros(M, dtype=torch.bool, device=dev),
        ]
    )
    j = _seg_search(pf.pm_pos, s_lo[None], s_hi[None], q, right, search_steps) - s_lo[None]
    r_hi = j[0]
    r_lo = torch.minimum(torch.maximum(j[1], j[2]), r_hi)
    return r_lo.to(torch.int32), r_hi.to(torch.int32)


def _fold_node_level(time_tab, cum_tab, s_lo, s_hi, t_b, right_b, qtl, qtr,
                     steps: int, k_t: int):
    """One level's q_t-folded paired node values: [NL·2, W, 2k_s].

    Per (boundary, window, node) binary search in the node's time-sorted run
    [s_lo, s_hi), raw-Φ prefix difference (node-local rounding), combo slice
    per side/half, q_t contraction, and the paired [k_s left | k_s right] row
    packing with W inside the row — exactly the layout :func:`packed_walk`
    and the fused kernel consume.
    """
    NL = s_lo.shape[0]
    W = qtl.shape[0]
    K = cum_tab.shape[-1]
    k_s = K // k_t
    i_b = _seg_search(
        time_tab, s_lo[None, None], s_hi[None, None],
        t_b[..., None], right_b[..., None], steps,
    )  # [3, W, NL]

    def pref(i, combos):
        v = cum_tab[:, combos][(i - 1).clamp_min(0)]  # [W, NL, 2, K]
        return torch.where((i > s_lo[None])[..., None, None], v, 0.0)

    # combos (0, 2) = (ψ_c, ψ_d) × left half; (1, 3) = the same × right half
    left = (pref(i_b[1], slice(0, None, 2)) - pref(i_b[0], slice(0, None, 2)))
    right = (pref(i_b[2], slice(1, None, 2)) - pref(i_b[1], slice(1, None, 2)))
    left = left.reshape(W, NL, 2, k_s, k_t)
    right = right.reshape(W, NL, 2, k_s, k_t)
    vl = left[..., 0] * qtl[:, None, None, None, 0]
    vr = right[..., 0] * qtr[:, None, None, None, 0]
    for t in range(1, k_t):
        vl = vl + left[..., t] * qtl[:, None, None, None, t]
        vr = vr + right[..., t] * qtr[:, None, None, None, t]
    vv = torch.cat([vl, vr], dim=-1)  # [W, NL, 2, 2k_s]
    return vv.permute(1, 2, 0, 3).reshape(NL * 2, W, 2 * k_s)


def packed_node_tables(
    pf: PackedForest,
    wb: WindowBatch,
    node_starts: Sequence[torch.Tensor],
    *,
    steps_per_level: tuple,
    k_t: int,
):
    """q_t-folded paired window values of EVERY position-rank node: [R·2, W, C].

    ``node_starts`` is a tuple of per-level index tensors: the flat pm_time
    offsets of every level-ℓ node's time-sorted run (length 2^ℓ). Per node
    the three window boundaries are binary-searched in the run — O(nodes)
    total, NOT O(atoms) — the raw-Φ prefix rows are differenced node-locally
    and contracted with the temporal query vectors immediately, so the walk
    gathers finished values. Row (node, side) = [k_s left-half | k_s right],
    with the W axis inside the row: one walk gather moves every window's
    value for a node at once. Node ids follow ``pf.node_base`` level-major.
    Levels are folded ``FOLD_CHUNK`` nodes at a time (same values, bounded
    transient memory).
    """
    t_b, right_b = _dyn_boundaries(wb)
    qtl, qtr = wb.qt[0::2], wb.qt[1::2]
    parts = []
    for lev, ns in enumerate(node_starts):
        for c0 in range(0, ns.shape[0], FOLD_CHUNK):
            s_lo = ns[c0 : c0 + FOLD_CHUNK]
            parts.append(
                _fold_node_level(
                    pf.pm_time, pf.pm_cum, s_lo, s_lo + (1 << lev), t_b, right_b,
                    qtl, qtr, int(steps_per_level[lev]), k_t,
                )
            )
    return torch.cat(parts, dim=0)


def packed_walk(nodeval, node_base_lvl, eid, side, r_lo, r_hi, *, max_levels: int):
    """Canonical ≤2-nodes-per-level walk over finished node values: [M, W, C].

    ``node_base_lvl`` [Lmax, E] maps walk levels to flat node bases. State
    is [M] ints — no window axis — and each level pays exactly ONE paired
    gather ([2, M] node rows, every window riding inside the row).
    """
    M = eid.shape[0]
    R2, W, C = nodeval.shape
    acc = torch.zeros((M, W, C), dtype=nodeval.dtype, device=nodeval.device)
    l = r_lo.to(torch.int64)
    r = r_hi.to(torch.int64)
    side = side.to(torch.int64)
    for lev in range(max_levels):
        nb = node_base_lvl[lev][eid]
        emit_l = (l < r) & ((l & 1) == 1)
        b_l = l
        l = torch.where(emit_l, l + 1, l)
        emit_r = (l < r) & ((r & 1) == 1)
        b_r = r - 1
        r = torch.where(emit_r, r - 1, r)
        on = torch.stack([emit_l, emit_r])  # [2, M]
        idx = (nb[None] + torch.stack([b_l, b_r])) * 2 + side[None]
        idx = torch.where(on, idx, 0).clamp(0, R2 - 1)
        rows = nodeval[idx]  # [2, M, W, C] — one paired gather per level
        rows = torch.where(on[..., None, None], rows, 0.0)
        acc = acc + (rows[0] + rows[1])
        l, r = l >> 1, r >> 1
    return acc


def eval_atoms_packed(
    nodeval, node_base_lvl, atoms: FlatAtoms, r_lo, r_hi, *, max_levels: int
):
    """Packed-plan per-atom aggregate for every half-window: [Wh, M].

    Row order is (w0 left, w0 right, w1 left, ...); callers fold halves and
    scatter onto lixels. Consumes precomputed root rank intervals +
    q_t-folded node value tables.
    """
    k_s = atoms.qs.shape[1]
    M = atoms.edge.shape[0]
    acc = packed_walk(
        nodeval, node_base_lvl, atoms.edge, atoms.side_feat, r_lo, r_hi,
        max_levels=max_levels,
    )
    # unrolled multiply-add over k_s (see the module note on duplicate
    # window centers)
    val_l = acc[..., 0] * atoms.qs[:, None, 0]  # [M, W]
    val_r = acc[..., k_s] * atoms.qs[:, None, 0]
    for s in range(1, k_s):
        val_l = val_l + acc[..., s] * atoms.qs[:, None, s]
        val_r = val_r + acc[..., k_s + s] * atoms.qs[:, None, s]
    out = torch.stack([val_l.T, val_r.T], dim=1).reshape(-1, M)
    return torch.where(atoms.valid[None, :], out, 0.0)
