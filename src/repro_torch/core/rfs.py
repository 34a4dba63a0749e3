"""Range Forest Solution (paper §4), dense-array form.

The paper's range forest is a *persistent* spatial range tree whose versions
are the time-sorted insertion prefixes; a time window is answered by
subtracting two versions while descending both roots in lockstep
(``DualDetect``, Algorithm 2).

Dense-array equivalent (see DESIGN.md §2): a **time-hierarchical merge tree**.
Per edge with n_e events (time-sorted = the version axis):

  level ℓ buckets 2^ℓ consecutive time-ranks; inside a bucket, events are
  position-sorted and carry inclusive prefix sums of the moment block Φ
  ([4 combos, K features], see aggregation.py).

A query (time-rank interval × position interval) decomposes canonically into
<= 2 buckets per level (exactly the nodes the paper's DualDetect touches);
each bucket contributes a difference of two prefix-sum rows located by binary
search. Identical outputs, O(n_e log n_e) space, zero data-dependent control
flow — every step is a masked gather, so the whole thing batches over
(lixels × edges × windows).

NumPy query engines, selectable with ``cascade``:
  * ``cascade=False`` — per-bucket binary searches: O(log² n_e) compare steps
    per query (a binary search inside each canonical bucket).
  * ``cascade=True``  — fractional cascading (beyond-paper §Perf
    optimization): the three position bounds are binary-searched **once** in
    the root bucket, then walked down the two boundary paths with O(1)
    precomputed bridge gathers per level — restoring the paper's O(log n_e)
    bound (their Lemma 4.1) and cutting the vectorized step count ~log n ×.

The device engine (``FlatForestEngine``) runs the packed query plan
(DESIGN.md §7) in PyTorch: host plans cached per snapshot epoch, window
tables per ts tuple, and the executors — the gather-lean ``packed`` walk
in plain torch (default) and ``fused``, ONE hand-written CUDA ``fused_walk``
launch per flush (``repro_torch.kernels.fused_walk``) reading the window
table in place, both over the position-major tables, and ``kernel``, the
per-bucket-search tier: ONE ``tree_query`` launch per flush over the flat
forest's time-major tables (``repro_torch.kernels.tree_query``), and the
reference's ``search`` / ``cascade`` tiers in plain torch over the same
tables. Every flush ends in ``ops.segment_add``, the fixed-order scatter
onto the heatmap (one launch per pack on the card).

``FlatDynamicEngine`` does the same for the streaming DRFS index
(``drfs.DynamicRangeForest``): device packs per snapshot epoch, window tables
per (ts tuple, structure epoch, mode), and per atom block either the plain
torch flush (``packed``) or ONE kernel launch for the tree phase on the
window table in place (``fused``: ``fused_leaf`` in quantized mode,
``fused_walk`` over the complete tree in exact mode; ``kernel``:
``dyn_leaf_query_flat`` and ``dyn_node_walk_flat``, the same two kernels
counted under the kernel tier's names) plus the masked boundary-leaf and
pending scans in plain torch.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from .aggregation import (
    MomentContext,
    N_COMBOS,
    next_pow2,
    segmented_cumsum,
    segmented_searchsorted,
    window_rank_ranges,
    window_rank_ranges_multi,
)
from .events import EdgeEvents
from .network import RoadNetwork
from ..kernels import ops
from .. import obs
from .plan import AtomSet
from .query_plan import PlanCache, group_atoms_by_edge
from .torch_engine import (
    FlatAtoms,
    FlatDynamicForest,
    FlatForest,
    TableCodec,
    WindowBatch,
    _dyn_leaf_range,
    dyn_node_base,
    dyn_node_tables,
    dyn_window_tables,
    eval_atoms_dyn,
    eval_atoms_flat,
    eval_atoms_packed,
    packed_forest_from_numpy,
    packed_node_tables,
    packed_root_ranks,
    rank_boundaries,
)

__all__ = [
    "RangeForest",
    "FlatDynamicEngine",
    "FlatForestEngine",
    "build_packed_host_tables",
    "make_window_batch",
]


class RangeForest:
    """Static exact index over all edges (paper's RFS, Lemma 4.3)."""

    def __init__(
        self,
        net: RoadNetwork,
        ee: EdgeEvents,
        ctx: MomentContext,
        phi: np.ndarray,
        *,
        build_bridges: bool = True,
    ):
        self.net = net
        self.ee = ee
        self.ctx = ctx
        E = net.n_edges
        counts = np.diff(ee.ptr)
        self.n_pad = np.array([next_pow2(c) if c else 0 for c in counts], dtype=np.int64)
        self.n_levels = np.array(
            [int(p).bit_length() if p else 0 for p in self.n_pad], dtype=np.int64
        )
        self.max_levels = int(self.n_levels.max(initial=0))
        block = self.n_pad * self.n_levels
        self.edge_base = np.zeros(E + 1, dtype=np.int64)
        np.cumsum(block, out=self.edge_base[1:])
        T = int(self.edge_base[-1])
        K = ctx.K
        self.pos_flat = np.full(T, np.inf, dtype=np.float64)
        self.cum_flat = np.zeros((T, N_COMBOS, K), dtype=np.float64)
        self.has_bridges = build_bridges
        # bridge[slot] for slot i-1 within a bucket at level l>=1 gives
        # bl(i) = #(first i position-sorted elements) landing in the LEFT child
        self.bridge = np.zeros(T, dtype=np.int32) if build_bridges else None
        # O(1) whole-edge window aggregates for Lixel Sharing: inclusive
        # prefix sums of Φ in raw time order, per edge.
        self.time_cum = np.cumsum(phi, axis=0, dtype=np.float64) if len(phi) else phi
        # raw event moments, kept by reference: the packed-plan engine builds
        # its position-major tables from these (exact rows, not prefix diffs)
        self.phi = phi
        self._ptr = ee.ptr
        self.index_bytes = (
            self.pos_flat.nbytes
            + self.cum_flat.nbytes
            + (self.bridge.nbytes if build_bridges else 0)
            + self.time_cum.nbytes
            + self.phi.nbytes
        )

        for e in range(E):
            n = int(counts[e])
            if n == 0:
                continue
            npad = int(self.n_pad[e])
            nlev = int(self.n_levels[e])
            lo = int(ee.ptr[e])
            pos = np.full(npad, np.inf, dtype=np.float64)
            pos[:n] = ee.pos[lo : lo + n]
            ph = np.zeros((npad, N_COMBOS, K), dtype=np.float64)
            ph[:n] = phi[lo : lo + n]
            base = int(self.edge_base[e])
            ranks = np.arange(npad, dtype=np.int64)
            for lev in range(nlev):
                bucket = ranks >> lev
                order = np.lexsort((pos, bucket))
                bsize = 1 << lev
                bptr = np.arange(0, npad + 1, bsize)
                cs = segmented_cumsum(ph[order], bptr)
                sl = base + lev * npad
                self.pos_flat[sl : sl + npad] = pos[order]
                self.cum_flat[sl : sl + npad] = cs
                if build_bridges and lev >= 1:
                    to_left = (((ranks[order] >> (lev - 1)) & 1) == 0).astype(np.int64)
                    blc = segmented_cumsum(to_left, bptr)
                    self.bridge[sl : sl + npad] = blc.astype(np.int32)

    # ------------------------------------------------------------------ LS
    def window_edge_totals_multi(self, edges: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Whole-edge aggregates over W split windows: [W, n, 2(l/r), 4, K].

        O(1) per (edge, window) — the root-node shortcut Lixel Sharing relies
        on (§6), swept over all windows in one vectorized pass.
        """
        edges = np.asarray(edges, dtype=np.int64)
        lo, mid, hi = window_rank_ranges_multi(self.ee, edges, ts, self.ctx.b_t)
        base = self._ptr[edges][None, :]

        def prefix(c):
            # time_cum is a *global* inclusive cumsum; differences of two
            # prefixes within one edge cancel everything before the edge.
            idx = base + c - 1
            val = self.time_cum[np.maximum(idx, 0)]
            return np.where((idx >= 0)[..., None, None], val, 0.0)

        p_lo, p_mid, p_hi = prefix(lo), prefix(mid), prefix(hi)
        return np.stack([p_mid - p_lo, p_hi - p_mid], axis=2)

    def window_edge_totals(self, edges: np.ndarray, t: float) -> np.ndarray:
        """Single-window form of :meth:`window_edge_totals_multi`: [n, 2, 4, K]."""
        return self.window_edge_totals_multi(edges, np.array([float(t)]))[0]

    def dominated_moments_multi(self, edges: np.ndarray, ts: np.ndarray, side: int) -> np.ndarray:
        """LS root-node shortcut, window-batched: M [W, n, k_s] such that
        F_e(q) = Q_s(d(q, v_side)) · M[w] for a dominated edge (§6.2)."""
        ctx = self.ctx
        ts = np.asarray(ts, dtype=np.float64)
        totals = self.window_edge_totals_multi(edges, ts)  # [W, n, 2, 4, K]
        W, n = totals.shape[:2]
        qt = np.stack(
            [[ctx.qt_left(t) for t in ts], [ctx.qt_right(t) for t in ts]], axis=1
        )  # [W, 2, k_t]
        M = np.zeros((W, n, ctx.k_s))
        for w in (0, 1):
            A = totals[:, :, w, side * 2 + w].reshape(W, n, ctx.k_s, ctx.k_t)
            M += np.einsum("wnst,wt->wns", A, qt[:, w])
        return M

    def dominated_moments(self, edges: np.ndarray, t: float, side: int) -> np.ndarray:
        """Single-window form of :meth:`dominated_moments_multi`: [n, k_s]."""
        return self.dominated_moments_multi(edges, np.array([float(t)]), side)[0]

    # --------------------------------------------------------------- queries
    def eval_atoms(self, atoms: AtomSet, t: float, *, cascade: bool = True) -> np.ndarray:
        """Σ K_s·K_t per atom for the window [t-b_t, t+b_t]; float64 [M]."""
        M = atoms.m
        if M == 0:
            return np.zeros(0)
        ctx = self.ctx
        uniq, inv = np.unique(atoms.edge, return_inverse=True)
        lo_u, mid_u, hi_u = window_rank_ranges(self.ee, uniq, t, ctx.b_t)
        qt = (ctx.qt_left(t), ctx.qt_right(t))
        out = np.zeros(M)
        engine = self._decompose_cascade if (cascade and self.has_bridges) else self._decompose_search
        for w in (0, 1):
            r_lo = (lo_u if w == 0 else mid_u)[inv]
            r_hi = (mid_u if w == 0 else hi_u)[inv]
            q_full = (atoms.qs[:, :, None] * qt[w][None, :]).reshape(M, -1)
            combo = atoms.side_feat.astype(np.int64) * 2 + w
            out += engine(atoms, r_lo, r_hi, combo, q_full)
        return out

    # ---- shared: dot an interval of a bucket with the query vector --------
    def _interval_dot(self, idx, seg_lo, i_lo, i_hi, combo, q_full):
        c = combo[idx]
        i_hi = np.maximum(i_hi, i_lo)

        def pref(i):
            v = self.cum_flat[np.maximum(i - 1, 0), c]
            return np.where((i > seg_lo)[:, None], v, 0.0)

        mom = pref(i_hi) - pref(i_lo)
        return np.einsum("mk,mk->m", q_full[idx], mom)

    # ---- engine 1: per-bucket binary search --------------------------------
    def _decompose_search(self, atoms, r_lo, r_hi, combo, q_full):
        M = atoms.m
        eid = atoms.edge
        npad = self.n_pad[eid]
        base = self.edge_base[eid]
        out = np.zeros(M)
        l = r_lo.astype(np.int64).copy()
        r = r_hi.astype(np.int64).copy()
        for lev in range(self.max_levels):
            active = l < r
            if not active.any():
                break
            for side in (0, 1):
                if side == 0:
                    emit = active & ((l & 1) == 1)
                    b = l
                else:
                    emit = active & ((r & 1) == 1)
                    b = r - 1
                idx = np.nonzero(emit)[0]
                if len(idx):
                    seg_lo = base[idx] + lev * npad[idx] + (b[idx] << lev)
                    seg_hi = seg_lo + (1 << lev)
                    out[idx] += self._bucket_moment(atoms, idx, seg_lo, seg_hi, combo, q_full)
            l = np.where(active & ((l & 1) == 1), l + 1, l) >> 1
            r = np.where(active & ((r & 1) == 1), r - 1, r) >> 1
        return out

    def _bucket_moment(self, atoms, idx, seg_lo, seg_hi, combo, q_full):
        n = len(idx)
        i_hi = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_hi[idx], np.ones(n, bool)
        )
        i_lo1 = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_lo1[idx], atoms.lo1_right[idx]
        )
        i_lo2 = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_lo2[idx], np.zeros(n, bool)
        )
        i_lo = np.maximum(i_lo1, i_lo2)
        return self._interval_dot(idx, seg_lo, i_lo, i_hi, combo, q_full)

    # ---- engine 2: fractional cascading ------------------------------------
    # Top-down two-boundary-path walk. State per atom: current level, the two
    # path nodes (bucket ids), and for each path the three cascaded insertion
    # ranks (hi, lo1, lo2), each *local* to the path node. The three bounds
    # are binary-searched once, at the root; every further level is pure
    # gathers through the `bridge` table.
    def _decompose_cascade(self, atoms, r_lo, r_hi, combo, q_full):
        M = atoms.m
        eid = atoms.edge
        npad = self.n_pad[eid]
        nlev = self.n_levels[eid]
        base = self.edge_base[eid]
        out = np.zeros(M)

        top = np.maximum(nlev - 1, 0)
        seg_lo = base + top * npad
        seg_hi = seg_lo + npad
        j_hi = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_hi, np.ones(M, bool)
        )
        j_lo1 = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_lo1, atoms.lo1_right
        )
        j_lo2 = segmented_searchsorted(
            self.pos_flat, seg_lo, seg_hi, atoms.pos_lo2, np.zeros(M, bool)
        )
        root_loc = np.stack([j_hi, j_lo1, j_lo2]) - seg_lo[None, :]  # [3, M]

        l = r_lo.astype(np.int64)
        r = r_hi.astype(np.int64)
        lev = top.copy()  # per-atom current level
        node = np.zeros((2, M), np.int64)  # path node (bucket id at `lev`)
        loc = np.stack([root_loc, root_loc.copy()])  # [2, 3, M]
        merged = np.ones(M, bool)
        alive = (l < r) & (nlev > 0)
        # path p alive flags (after split, tracked separately)
        palive = np.stack([alive.copy(), alive.copy()])

        def emit(mask, which, at_lev, at_node, at_loc):
            idx = np.nonzero(mask)[0]
            if not len(idx):
                return
            s_lo = base[idx] + at_lev[idx] * npad[idx] + (at_node[idx] << at_lev[idx])
            i_hi = s_lo + at_loc[0][idx]
            i_lo = s_lo + np.maximum(at_loc[1][idx], at_loc[2][idx])
            out[idx] += self._interval_dot(idx, s_lo, i_lo, i_hi, combo, q_full)

        def cascade(mask, p, child_is_right):
            """Move path p's ranks from its node into a child; update node."""
            idx = np.nonzero(mask)[0]
            if not len(idx):
                return
            nf = base[idx] + lev[idx] * npad[idx] + (node[p][idx] << lev[idx])
            for k in range(3):
                i = loc[p, k][idx]
                bl = np.where(i > 0, self.bridge[nf + np.maximum(i - 1, 0)], 0)
                loc[p, k][idx] = np.where(child_is_right[idx], i - bl, bl)
            node[p][idx] = (node[p][idx] << 1) + child_is_right[idx]

        def sibling_loc(mask, p, sib_is_right):
            """Ranks for the sibling child of path p's node (before descent)."""
            idx = np.nonzero(mask)[0]
            res = np.zeros((3, M), np.int64)
            if not len(idx):
                return res
            nf = base[idx] + lev[idx] * npad[idx] + (node[p][idx] << lev[idx])
            for k in range(3):
                i = loc[p, k][idx]
                bl = np.where(i > 0, self.bridge[nf + np.maximum(i - 1, 0)], 0)
                res[k][idx] = np.where(sib_is_right[idx], i - bl, bl)
            return res

        for _ in range(self.max_levels):
            act = palive[0] | palive[1]
            if not act.any():
                break
            bs = np.int64(1) << lev
            half = bs >> 1
            a0 = node[0] * bs  # merged/left-path node range start
            # --- merged phase -------------------------------------------
            m_act = merged & palive[0]
            exact = m_act & (a0 == l) & (a0 + bs == r)
            emit(exact, 0, lev, node[0], loc[0])
            palive[0] &= ~exact
            palive[1] &= ~exact
            m_act &= ~exact
            can_desc = m_act & (lev > 0)
            go_left = can_desc & (r <= a0 + half)
            go_right = can_desc & (l >= a0 + half)
            split = can_desc & ~go_left & ~go_right
            # split: right path takes the right child; copy state then descend
            if split.any():
                idx = np.nonzero(split)[0]
                node[1][idx] = node[0][idx]
                for k in range(3):
                    loc[1, k][idx] = loc[0, k][idx]
                merged[idx] = False
            cascade(go_left | split, 0, np.zeros(M, bool))
            cascade(go_right, 0, np.ones(M, bool))
            cascade(split, 1, np.ones(M, bool))
            # un-merged right path mirrors node updates only where merged still
            node[1] = np.where(merged, node[0], node[1])
            # --- split phase: left boundary path (interval [l, node_end)) ---
            s_act = ~merged & palive[0] & ~split  # split handled next round
            if s_act.any():
                full = s_act & (a0 == l)
                emit(full, 0, lev, node[0], loc[0])
                palive[0] &= ~full
                rest = s_act & ~full & (lev > 0)
                in_left = rest & (l < a0 + half)
                # emit right child (fully covered) then descend left
                sl = sibling_loc(in_left, 0, np.ones(M, bool))
                emit(in_left, 0, lev - 1, (node[0] << 1) + 1, sl)
                cascade(in_left, 0, np.zeros(M, bool))
                in_right = rest & ~in_left
                cascade(in_right, 0, np.ones(M, bool))
            # --- split phase: right boundary path (interval [node_start, r)) -
            r_act = ~merged & palive[1] & ~split
            if r_act.any():
                a1 = node[1] * bs
                full = r_act & (a1 + bs == r)
                emit(full, 1, lev, node[1], loc[1])
                palive[1] &= ~full
                rest = r_act & ~full & (lev > 0)
                in_right = rest & (r > a1 + half)
                sl = sibling_loc(in_right, 1, np.zeros(M, bool))
                emit(in_right, 1, lev - 1, node[1] << 1, sl)
                cascade(in_right, 1, np.ones(M, bool))
                in_left = rest & ~in_right
                cascade(in_left, 1, np.zeros(M, bool))
            moved = (m_act & (lev > 0)) | (~merged & (palive[0] | palive[1]) & (lev > 0))
            lev = np.where(moved, lev - 1, lev)
        return out


# ============================================================ device engine
# Host-side packing shared by the device executors.

def _size_class(m: int, floor: int = 256) -> int:
    """Round a ragged count up to an ⅛-octave size class. Kept where a
    padded shape is part of a kernel's contract: the per-edge atom capacity
    ``q_pad`` of the grouped [G, Qp] layout the fused kernel reads, so one
    plan produces O(log Q) distinct launch shapes. Above ~8·floor the
    padding waste is bounded by ~12%; below that the ``floor`` granularity
    dominates."""
    m = max(m, 1)
    if m <= floor:
        return floor
    gran = max(next_pow2(m) // 8, floor)
    return -(-m // gran) * gran


def make_window_batch(ctx: MomentContext, ts) -> Tuple[np.ndarray, ...]:
    """Host-side window tables for W centers → Wh = 2W half-window rows.

    Row order is (w0 left, w0 right, w1 left, ...) so engines can fold the
    two halves of a center with one reshape. Returns numpy arrays
    (t_lo, t_hi, lo_right, half, qt) ready to become a torch_engine.WindowBatch.
    """
    ts = [float(t) for t in ts]
    Wh = 2 * len(ts)
    t_lo = np.empty(Wh)
    t_hi = np.empty(Wh)
    lo_right = np.zeros(Wh, bool)
    half = np.zeros(Wh, np.int32)
    qt = np.empty((Wh, ctx.k_t))
    for w, t in enumerate(ts):
        # left half [t-b_t, t]: inclusive lower bound; right half (t, t+b_t]
        t_lo[2 * w], t_hi[2 * w] = t - ctx.b_t, t
        qt[2 * w] = ctx.qt_left(t)
        t_lo[2 * w + 1], t_hi[2 * w + 1] = t, t + ctx.b_t
        lo_right[2 * w + 1] = True
        half[2 * w + 1] = 1
        qt[2 * w + 1] = ctx.qt_right(t)
    return t_lo, t_hi, lo_right, half, qt


def _device_nbytes(obj, seen=None) -> int:
    """Total bytes of every device tensor reachable from ``obj`` — the ONE
    accounting helper for engine tables, atom packs and packed plans
    (accepts tensors, NamedTuples, dicts, lists/tuples and the DRFS packs,
    which carry their own ``nbytes``; anything else counts 0). A tensor
    reachable twice counts once: a pack's ``FlatIndex`` holds the pack's
    edges and the engine's node bases."""
    seen = set() if seen is None else seen
    if hasattr(obj, "element_size"):
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        return int(obj.numel()) * obj.element_size()
    if isinstance(obj, dict):
        return sum(_device_nbytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_device_nbytes(v, seen) for v in obj)
    if isinstance(obj, (_SealedPack, _PendPack)):
        return obj.nbytes
    return 0


def build_packed_host_tables(rf: RangeForest):
    """Position-major merge-tree tables for the packed-plan executor.

    The transpose of the ``RangeForest`` build: level ℓ buckets 2^ℓ
    consecutive POSITION-ranks; inside a bucket events are time-sorted and
    carry inclusive prefix sums of raw Φ. Returns a dict of host arrays for
    ``torch_engine.PackedForest`` plus the per-level node-start offsets
    (``node_starts``) and per-level search trip counts that
    ``packed_node_tables`` needs. Block sizes (n_pad, n_levels, edge_base)
    are shared with the time-major layout, so the two are the same size.
    """
    net, ee, ctx, phi = rf.net, rf.ee, rf.ctx, rf.phi
    E = net.n_edges
    counts = np.diff(ee.ptr)
    K = ctx.K
    n_pad = rf.n_pad
    n_lev = rf.n_levels
    edge_base = rf.edge_base
    Lmax = max(rf.max_levels, 1)
    pos_base = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(n_pad, out=pos_base[1:])
    P = int(pos_base[-1])
    T = int(edge_base[-1])
    pm_pos = np.full(max(P, 1), np.inf)
    pm_time = np.full(max(T, 1), np.inf)
    pm_cum = np.zeros((max(T, 1), N_COMBOS, K))
    node_base = np.zeros((E, Lmax), np.int64)
    starts: list = [[] for _ in range(Lmax)]
    nid = 0
    for lev in range(Lmax):
        for e in range(E):
            if lev >= n_lev[e]:
                continue
            nb_e = int(n_pad[e]) >> lev
            node_base[e, lev] = nid
            starts[lev].append(
                edge_base[e] + lev * n_pad[e] + np.arange(nb_e, dtype=np.int64) * (1 << lev)
            )
            nid += nb_e
    node_starts = tuple(
        np.concatenate(s).astype(np.int32) if s else np.zeros(1, np.int32)
        for s in starts
    )
    for e in range(E):
        n = int(counts[e])
        if n == 0:
            continue
        npad = int(n_pad[e])
        lo = int(ee.ptr[e])
        order0 = np.argsort(ee.pos[lo : lo + n], kind="stable")
        pm_pos[pos_base[e] : pos_base[e] + n] = ee.pos[lo : lo + n][order0]
        tms = np.full(npad, np.inf)
        tms[:n] = ee.time[lo : lo + n][order0]
        ph = np.zeros((npad, N_COMBOS, K))
        ph[:n] = phi[lo : lo + n][order0]
        ranks = np.arange(npad, dtype=np.int64)
        base = int(edge_base[e])
        for lev in range(int(n_lev[e])):
            bucket = ranks >> lev
            order = np.lexsort((tms, bucket))
            bptr = np.arange(0, npad + 1, 1 << lev)
            sl = base + lev * npad
            pm_time[sl : sl + npad] = tms[order]
            pm_cum[sl : sl + npad] = segmented_cumsum(ph[order], bptr)
    return dict(
        pm_pos=pm_pos,
        pos_base=pos_base[:-1],
        pm_time=pm_time,
        pm_cum=pm_cum,
        edge_base=edge_base[:-1].copy(),
        n_pad=n_pad,
        n_lev=n_lev,
        node_base=node_base.astype(np.int32),
        node_starts=node_starts,
        n_nodes=nid,
        steps_per_level=tuple(lev + 1 for lev in range(Lmax)),
    )


class _DeviceEngine:
    """Shared device plumbing for the flat query engines: window batches,
    the device-resident [L, W] heatmap, atom padding, and the final
    device->host transfer. Subclasses own the index packing and flush."""

    def _init_device(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain-torch path on the host"
            )
        self._wb_cache = PlanCache(8)
        # op accounting for QueryStats (n_rank_searches / n_moment_gathers /
        # bytes_moved): time-boundary search problems solved, prefix/node
        # moment rows gathered, and the bytes those gathers move (gather
        # count × gathered-row bytes) — host-side formulas matching what the
        # executors dispatch. fused_launches counts the fused executor's
        # launches (exactly ONE per atom pack); as in the reference, the
        # kernel executor's launches are not counted there (the wrappers'
        # own ``launches`` counts are). fold_launches counts the window-table
        # fold's kernel launches (one per fold of the packed executors on the
        # card, one per shard and fold when sharded; none on the CPU).
        self.counters = {
            "rank_searches": 0,
            "fold_launches": 0,
            "moment_gathers": 0,
            "bytes_moved": 0,
            "fused_launches": 0,
        }

    def _upload(self, a: np.ndarray):
        """Host array → device tensor without waiting for the card. A
        ``non_blocking`` copy from pageable host memory is staged by the
        driver before the call returns (the host array may change right
        after), and it skips the stream synchronisation that a blocking copy
        adds — so ``dispatch`` can pack flush N+1 while the card still runs
        flush N. A no-op on the CPU."""
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _f64(self, x):
        return self._upload(np.ascontiguousarray(x, dtype=np.float64))

    def _as(self, x, dtype):
        return self._upload(np.ascontiguousarray(x)).to(dtype)

    def window_batch(self, ctx: MomentContext, ts):
        """Device WindowBatch for the ts tuple, LRU-cached — repeated queries
        over the same centers reuse one device object (and everything keyed
        on it downstream: node values, grouped node values)."""
        ts_key = tuple(float(t) for t in ts)
        with obs.span("tnkde.window_batch") as sp:
            hit = self._wb_cache.get(ts_key)
            if sp is not None:
                sp["hit"] = hit is not None
            if hit is not None:
                return hit
            t_lo, t_hi, lo_right, half, qt = make_window_batch(ctx, ts)
            wb = WindowBatch(
                t_lo=self._f64(t_lo),
                t_hi=self._f64(t_hi),
                lo_right=self._as(lo_right, torch.bool),
                half=self._as(half, torch.int32),
                qt=self._f64(qt),
            )
            self._wb_cache.put(ts_key, wb)
            return wb

    def new_heatmap(self, n_lixels: int, n_windows: int):
        """Fresh device [L, W] float64 accumulator. Flushes add into it IN
        PLACE (one buffer per query, no per-block allocation)."""
        return torch.zeros((n_lixels, n_windows), dtype=torch.float64, device=self.device)

    def _flat_atoms(self, f: dict, edge: np.ndarray):
        """Host atom fields (any leading shape, flattened) → device FlatAtoms."""
        k_s = f["qs"].shape[-1]
        return FlatAtoms(
            lixel=self._as(f["lixel"].reshape(-1), torch.int64),
            edge=self._as(edge.reshape(-1), torch.int64),
            side_feat=self._as(f["side_feat"].reshape(-1), torch.int32),
            qs=self._f64(f["qs"].reshape(-1, k_s)),
            pos_hi=self._f64(f["pos_hi"].reshape(-1)),
            pos_lo1=self._f64(f["pos_lo1"].reshape(-1)),
            lo1_right=self._as(f["lo1_right"].reshape(-1), torch.bool),
            pos_lo2=self._f64(f["pos_lo2"].reshape(-1)),
            valid=self._as(f["valid"].reshape(-1), torch.bool),
        )

    def _device_atoms(self, atoms: AtomSet, sel: np.ndarray):
        """The selected atoms as device FlatAtoms. No padding: eager PyTorch
        has no compile cache to key on a size class, so the pack holds
        exactly ``len(sel)`` atoms, all valid."""
        sub = atoms.take(sel)
        fields = dict(
            lixel=sub.lixel,
            side_feat=sub.side_feat.astype(np.int32),
            qs=sub.qs,
            pos_hi=sub.pos_hi,
            pos_lo1=sub.pos_lo1,
            lo1_right=sub.lo1_right,
            pos_lo2=sub.pos_lo2,
            valid=np.ones(sub.m, bool),
        )
        return self._flat_atoms(fields, sub.edge)

    def to_numpy(self, heat) -> np.ndarray:
        """Device [L, W] heatmap → host [W, L] float64 (the one transfer)."""
        return heat.t().contiguous().cpu().numpy()

    def _segments(self, lixel, slots=None):
        """The fixed-order scatter's index of one pack (``ops.segment_index``):
        its real rows' lixels in plan order and, for a padded layout, the
        output slot of each. Built from host arrays, once per pack."""
        return ops.segment_index(lixel, slots, device=self.device)


def _kernel_launches() -> int:
    """Hand-written kernel launches an RFS flush makes (walk, tree query,
    scatter); the plain versions on the CPU launch none."""
    return ops.fused_walk.launches + ops.tree_query.launches + ops.segment_add.launches


def _rfs_flush(tabs, entry, heat):
    """ONE fused kernel launch on the window table in place: walk + window
    contraction, [G, Qp, W], added onto heat [L, W] in place by the
    fixed-order scatter. Padding slots of the [G, Qp] layout carry qs = 0
    and an empty interval, so the kernel writes exact zeros there; only the
    real atoms' slots (``entry["seg"]``) are added."""
    out = ops.fused_walk_flat(
        tabs.reshape(tabs.shape[0], -1), entry["index"], entry["r_lo"], entry["r_hi"],
        entry["side"], entry["qs"],
    )  # [G, Qp, W]
    ops.segment_add(heat, out.reshape(-1, heat.shape[1]), entry["seg"])


def tree_query_args(ff, ranks, entry, wb):
    """The inputs of the ONE ``tree_query`` launch of a kernel-executor flush:
    the flat forest's tables as they are, the entry's edge block starts and
    per-slot bounds, the per-edge (lo, mid, hi) time ranks as [G, Wh]
    intervals (row order w0 left, w0 right, w1 left, ...) and the
    half-window coefficients. No query vector is built here: the kernel
    builds it from ``qs``, ``qt``, ``side`` and ``half``."""
    G = entry["side"].shape[0]
    Wh = wb.t_lo.shape[0]
    k = ranks[:, :, entry["edges"]]  # [3, W, G]
    r_lo = torch.stack([k[0], k[1]], dim=1).reshape(Wh, G).T.contiguous()
    r_hi = torch.stack([k[1], k[2]], dim=1).reshape(Wh, G).T.contiguous()
    return ((ff.pos_flat, ff.cum_flat.reshape(ff.cum_flat.shape[0], -1), entry["base"], r_lo,
             r_hi, entry["pos_hi"], entry["pos_lo1"], entry["lo1_right"], entry["pos_lo2"],
             entry["qs"], wb.qt, entry["side"], wb.half), dict(npad=entry["npad"]))


def _rfs_kernel_flush(ff, ranks, entry, wb, heat):
    """ONE ``tree_query`` launch for the entry: [G, Qp, Wh], then the real
    atoms' rows, window halves folded, added onto heat [L, W] by the
    fixed-order scatter."""
    args, kw = tree_query_args(ff, ranks, entry, wb)
    out = ops.tree_query(*args, **kw)  # [G, Qp, Wh]
    ops.segment_add(heat, out.reshape(-1, out.shape[2]), entry["seg"], halves=True)


class FlatForestEngine(_DeviceEngine):
    """Device-resident window-batched query engine over a built RangeForest.

    Solves the multiple-temporal-KDE hot loop (§8.2) on the GPU with five
    interchangeable executors over the packed query plan (DESIGN.md §7):

      executor='packed'   (default) gather-lean plain-torch executor:
                          position-major node tables with q_t folded in,
                          built ONCE per (snapshot, window batch) and
                          LRU-cached; atoms carry cached root rank intervals,
                          so a steady-state flush is one canonical walk with
                          one paired gather per level — no searches at all.
      executor='fused'    ONE hand-written CUDA launch per atom pack: the
                          whole canonical walk + window contraction runs
                          in-kernel, reading the packed node values where
                          the window tables hold them (kernels/fused_walk.py).
      executor='kernel'   ONE hand-written CUDA ``tree_query`` launch per
                          atom pack over the flat forest's time-major tables
                          as they are (no per-entry copies): per (atom,
                          half-window) the canonical time-rank decomposition
                          with three position searches per bucket and the
                          query vector built in the kernel
                          (kernels/tree_query.py). Window-side state is the
                          [3, W, E] time-rank table (:func:`rank_boundaries`).
      executor='search'   the same decomposition in plain torch
                          (``torch_engine.eval_atoms_flat``), per LEVEL class.
      executor='cascade'  the fractional-cascading prefix-path walk over the
                          forest's bridges, plain torch, per LEVEL class; a
                          forest built without bridges (``cascade=False``)
                          runs ``search`` instead, as the reference does.

    All answer all W windows per flush into a device-resident [L, W]
    heatmap (float64 — exactness is part of the paper's claim), transferred
    once per query. ``device`` defaults to ``'cuda'``; with no card the
    constructor raises (pass ``device='cpu'`` for the plain-torch path).

    ``codec`` (:class:`torch_engine.TableCodec`) sets the storage dtype of
    the packed and fused executors' node-value window tables, validated
    once against the host prefix moments (a failed round trip falls back to
    f64 in place: ``codec.fallback_reason``). The ``kernel`` executor reads
    the raw f64 forest, as the reference's pallas tier does: its codec is
    the identity whatever was asked.
    """

    def __init__(self, rf: RangeForest, *, executor: str = "packed",
                 device="cuda", host_tables: dict = None, codec="auto"):
        self._init_device(device)
        if executor in ("auto", None):
            executor = "packed"
        if executor not in ("packed", "fused", "kernel", "search", "cascade"):
            raise ValueError(f"unknown rfs executor {executor!r}")
        if executor == "cascade" and not rf.has_bridges:
            executor = "search"
        self.rf = rf
        self.executor = executor
        # the time-major executors read the raw f64 forest: no window-table codec
        time_major = executor in ("kernel", "search", "cascade")
        self.codec = TableCodec("f64" if time_major else codec)
        self.max_levels = max(rf.max_levels, 1)
        npmax = max(int(rf.n_pad.max(initial=1)), 1)
        nemax = max(int(np.diff(rf.ee.ptr).max(initial=1)), 1)
        self.search_steps = max(int(np.ceil(np.log2(max(npmax, nemax) + 1))) + 1, 1)
        self._tab_cache = PlanCache(2)  # ts_key -> window tables (plans)
        self._pack_cache = PlanCache(2)  # plan.key -> device atom packs
        self._packed = self._flat = None
        if time_major:
            self._flat = self._flat_forest()
        else:
            host = build_packed_host_tables(rf) if host_tables is None else host_tables
            # build-time round trip of the f64 prefix moments: a codec that
            # cannot hold this forest degrades to f64 in place
            self.codec.validate(host["pm_cum"])
            pf, meta = packed_forest_from_numpy(host, self.device)
            # the host copy of the walk's node bases: range checks read it
            self._packed = dict(pf=pf, node_base_lvl_host=np.ascontiguousarray(
                np.asarray(host["node_base"], np.int64).T), **meta)

    @classmethod
    def from_host_tables(cls, rf: RangeForest, host: dict, *,
                         executor: str = "packed", device="cuda", codec="auto"):
        """Engine over index state built elsewhere: ``host`` is the dict
        ``build_packed_host_tables`` returns (this package's or the
        reference's); ``rf`` supplies the block sizes and the context. The
        ``kernel`` executor reads ``rf``'s time-major tables instead."""
        return cls(rf, executor=executor, device=device, host_tables=host, codec=codec)

    def _flat_forest(self) -> FlatForest:
        """The RangeForest's time-major tables on the device (the ``kernel``
        executor). Empty tables get one padding row: gathers never see an
        empty source."""
        rf = self.rf

        def pad1(x, fill):
            return x if x.shape[0] else np.full((1,) + x.shape[1:], fill, x.dtype)

        bridge = rf.bridge if rf.bridge is not None else np.zeros(1, np.int32)
        return FlatForest(
            pos_flat=self._f64(pad1(rf.pos_flat, np.inf)),
            cum_flat=self._f64(pad1(rf.cum_flat, 0.0)),
            edge_base=self._as(rf.edge_base[:-1], torch.int64),
            n_pad=self._as(rf.n_pad, torch.int64),
            n_lev=self._as(rf.n_levels, torch.int64),
            time_flat=self._f64(pad1(rf.ee.time, np.inf)),
            time_ptr=self._as(rf.ee.ptr, torch.int64),
            bridge=self._as(pad1(bridge, 0), torch.int32),
        )

    @property
    def device_bytes(self) -> int:
        """Index tables + cached packed plans (atom packs, window tables)."""
        return _device_nbytes(
            [
                self._flat,
                self._packed,
                list(self._tab_cache.values()),
                list(self._pack_cache.values()),
            ]
        )

    @property
    def bytes_per_shard(self) -> int:
        """Device bytes each participating device holds — the single-device
        engine IS one shard, so this equals :attr:`device_bytes`."""
        return self.device_bytes

    # ----------------------------------------------------- plan-side caches
    def _atom_packs(self, plan):
        """Device atom packs for a HostPlan, with the window-independent root
        position-rank interval of every atom (searched once per plan, ever).

        packed, search, cascade: per block, per LEVEL class (edge tree depth
        rounded up to multiples of 3, so shallow-edge atoms never walk the
        deepest edge's level count; only packed resolves root ranks). fused /
        kernel: per block, per NPAD class
        (:meth:`_fused_pack`, :meth:`_kernel_pack`).
        """
        key = (plan.key, self.executor)
        with obs.span("tnkde.packs") as sp:
            hit = self._pack_cache.get(key)
            if sp is not None:
                sp["hit"] = hit is not None
            if hit is not None:
                return hit
            packs = []
            for atoms in plan.blocks:
                if self.executor == "fused":
                    packs.extend(self._fused_pack(atoms))
                    continue
                if self.executor == "kernel":
                    packs.extend(self._kernel_pack(atoms))
                    continue
                nl = self.rf.n_levels[atoms.edge]
                cls = np.minimum(-(-nl // 3) * 3, self.max_levels).astype(np.int64)
                for c in np.unique(cls):
                    sel = np.nonzero(cls == c)[0]
                    fa = self._device_atoms(atoms, sel)
                    if self.executor != "packed":  # search / cascade: no root ranks
                        packs.append(dict(max_levels=int(c), fa=fa, m=len(sel),
                                          seg=self._segments(atoms.lixel[sel])))
                        continue
                    r_lo, r_hi = packed_root_ranks(
                        self._packed["pf"], fa, search_steps=self.search_steps
                    )
                    packs.append(
                        dict(max_levels=int(c), fa=fa, m=len(sel), r_lo=r_lo, r_hi=r_hi,
                             seg=self._segments(atoms.lixel[sel]))
                    )
            self._pack_cache.put(key, packs)
            return packs

    def _grouped(self, atoms):
        """The per-edge grouped [G, Qp] layout of one atom block, one entry
        per NPAD size class (every group in a launch shares its table shape):
        yields ``(npad, fa, entry)`` with the grouped atoms as device
        FlatAtoms and the entry fields every kernel flush reads, already in
        the kernels' types — masked ``qs`` (padding rows zeroed), int32
        sides, the flat [G·Qp] slots of the real atoms and their lixels."""
        npad_of = self.rf.n_pad[atoms.edge]
        for p in np.unique(npad_of):
            sub = atoms.take(np.nonzero(npad_of == p)[0])
            _, cnt = np.unique(sub.edge, return_counts=True)
            qp = _size_class(int(cnt.max(initial=1)), floor=16)
            edges, fields, _ = group_atoms_by_edge(sub, q_pad=qp)
            G = len(edges)
            fa = self._flat_atoms(
                fields, np.broadcast_to(edges[:, None], fields["lixel"].shape)
            )
            slots = np.flatnonzero(fields["valid"])  # the real atoms' [G·Qp] slots
            yield int(p), fa, dict(
                edges=self._as(edges, torch.int64),
                edges_host=np.asarray(edges, np.int64),  # host copy for range checks
                seg=self._segments(fields["lixel"].reshape(-1)[slots], slots),
                side=fa.side_feat.reshape(G, qp),
                qs=(fa.qs * fa.valid[:, None]).reshape(G, qp, -1),
                m=sub.m,
            )

    def _fused_pack(self, atoms):
        """Grouped packed-plan layout for the fused executor, with the
        window-independent root rank intervals searched once per plan and
        cached on the entry, and where its edges' node rows lie in the
        window tables (``index``: walk level ℓ of edge e holds npad >> ℓ
        nodes from ``node_base_lvl[ℓ, e]``, range-checked here, once) — the
        fused kernel's only remaining input is the ts-keyed window table."""
        entries = []
        for p, fa, entry in self._grouped(atoms):
            G, qp = entry["side"].shape
            r_lo, r_hi = packed_root_ranks(
                self._packed["pf"], fa, search_steps=self.search_steps
            )
            entry.update(r_lo=r_lo.reshape(G, qp), r_hi=r_hi.reshape(G, qp), npad=p,
                         max_levels=p.bit_length(),
                         index=ops.walk_index(self._packed["node_base_lvl"], entry["edges"], p,
                                              lvl_base_host=self._packed["node_base_lvl_host"],
                                              edges_host=entry["edges_host"]))
            entries.append(entry)
        return entries

    def _kernel_pack(self, atoms):
        """Grouped layout for the kernel executor: per entry the first row
        of each edge's block in the flat forest (``base``; the tables stay
        where the forest holds them) and the atoms' three position bounds,
        so a flush only adds the ts-keyed ranks."""
        ff = self._flat
        entries = []
        for p, fa, entry in self._grouped(atoms):
            G, qp = entry["side"].shape
            entry.update(
                base=ff.edge_base[entry["edges"]],
                npad=p,
                pos_hi=fa.pos_hi.reshape(G, qp),
                pos_lo1=fa.pos_lo1.reshape(G, qp),
                lo1_right=fa.lo1_right.reshape(G, qp).to(torch.int32),
                pos_lo2=fa.pos_lo2.reshape(G, qp),
                max_levels=p.bit_length(),
            )
            entries.append(entry)
        return entries

    def window_tables(self, wb, ts_key):
        """Per-(window batch) derived tables, LRU-cached by the ts tuple.

        packed / fused: q_t-folded paired node values (the plan's core hoist
        — every time search and every per-node prefix gather happens HERE,
        at node count scale, never per atom), stored in the codec's fold
        dtype. kernel, search, cascade: the [3, W, E] time-rank boundary
        table shared by every flush of the query.
        """
        key = (ts_key, self.executor, self.codec.name)
        with obs.span("tnkde.tables") as sp:
            hit = self._tab_cache.get(key)
            if sp is not None:
                sp.update(hit=hit is not None, launches=0)
            if hit is not None:
                return hit
            W = len(ts_key)
            K = self.rf.ctx.K
            if self._flat is not None:
                tabs = rank_boundaries(self._flat, wb, search_steps=self.search_steps)
                self.counters["rank_searches"] += 3 * W * self.rf.net.n_edges
                self._tab_cache.put(key, tabs)
                return tabs
            pk = self._packed
            l0 = ops.fold_node_tables.launches
            tabs = packed_node_tables(
                pk["pf"], wb, pk["starts"], lvl_ptr=pk["lvl_ptr"],
                steps_per_level=pk["steps_per_level"], k_t=int(self.rf.ctx.k_t),
                out_dtype=self.codec.fold_dtype,
            )
            launched = ops.fold_node_tables.launches - l0  # 1 on the card, 0 on the CPU
            self.counters["fold_launches"] += launched
            if sp is not None:
                sp["launches"] = launched
            nn = max(pk["n_nodes"], 1)
            self.counters["rank_searches"] += 3 * W * nn
            self.counters["moment_gathers"] += 3 * W * nn
            # fold gathers read paired raw-Φ prefix rows from the f64 host-layout
            # tables (the codec shrinks only the derived window tables)
            self.counters["bytes_moved"] += 3 * W * nn * N_COMBOS * K * 8
            self._tab_cache.put(key, tabs)
            return tabs

    # ------------------------------------------------------------ per query
    def flush_plan(self, heat, plan, wb, ts_key, **_):
        """heat[L, W] += every atom block of the plan, all W windows.

        All window-dependent tables come from the ts-keyed cache, all
        atom-side state from the plan's pack cache — in steady state the
        only work left is the walks (packed) or one launch per pack (fused,
        kernel).
        """
        if plan.n_atoms == 0:
            return heat
        tabs = self.window_tables(wb, ts_key)
        packs = self._atom_packs(plan)
        W = len(ts_key)
        k_s = self.rf.ctx.k_s
        # the per-atom walk gathers q_t-folded node-value rows [W, 2k_s] in
        # the codec's fold dtype — the bytes-per-gather knob
        row_bytes = W * 2 * k_s * self.codec.fold_itemsize
        pk = self._packed
        with obs.span("tnkde.launch", packs=len(packs)) as sp:
            launches0 = _kernel_launches() if sp is not None else 0
            for entry in packs:
                c, m = entry["max_levels"], entry["m"]
                if self.executor in ("search", "cascade"):
                    cascade = self.executor == "cascade"
                    vals = eval_atoms_flat(
                        self._flat, entry["fa"], wb, tabs, max_levels=c,
                        search_steps=self.search_steps, cascade=cascade,
                    )  # [Wh, M]
                    ops.segment_add(heat, vals.T, entry["seg"], halves=True)
                    # paired hi/lo prefix rows: cascade pays one stacked gather per
                    # (boundary, level); search two buckets of two rows per
                    # (half-window, level) — the reference's counts for these tiers
                    gathers = 2 * 3 * W * m * (c + 1) if cascade else 4 * 2 * W * m * c
                    self.counters["moment_gathers"] += gathers
                    self.counters["bytes_moved"] += gathers * 2 * self.rf.ctx.K * 8
                    continue
                if self.executor == "kernel":
                    _rfs_kernel_flush(self._flat, tabs, entry, wb, heat)
                    # two buckets of two [4, K] prefix rows per (half-window,
                    # level) of every atom: the reference's count for this tier
                    gathers = 4 * 2 * W * m * c
                    self.counters["moment_gathers"] += gathers
                    self.counters["bytes_moved"] += gathers * N_COMBOS * self.rf.ctx.K * 8
                    continue
                if self.executor == "packed":
                    fa = entry["fa"]
                    vals = eval_atoms_packed(
                        tabs, pk["node_base_lvl"], fa, entry["r_lo"], entry["r_hi"],
                        max_levels=c,
                    )  # [Wh, M]
                    ops.segment_add(heat, vals.T, entry["seg"], halves=True)
                else:
                    _rfs_flush(tabs, entry, heat)
                    # ONE kernel launch answered the whole pack; the walk still
                    # touches the same node rows
                    self.counters["fused_launches"] += 1
                self.counters["moment_gathers"] += 2 * c * m
                self.counters["bytes_moved"] += 2 * c * m * row_bytes
            if sp is not None:
                sp["launches"] = _kernel_launches() - launches0
        return heat


# ===================================================================== DRFS
def _dyn_plain_flush(forest, fa, seg, wb, tables, heat, *, n_levels: int, hq: int,
                     scan_steps: int, pend_steps: int, exact: bool, tree: bool = True):
    """heat[L, W] += one atom block through :func:`eval_atoms_dyn` (all
    three phases, or only the scans with ``tree=False``), in place, window
    halves folded by the fixed-order scatter over ``seg``."""
    vals = eval_atoms_dyn(
        forest, fa, wb, tables, n_levels=n_levels, hq=hq, scan_steps=scan_steps,
        pend_steps=pend_steps, exact=exact, tree=tree,
    )  # [Wh, M]
    ops.segment_add(heat, vals.T, seg, halves=True)


def dyn_kernel_call(forest, tab, entry, wb, *, hq: int, exact: bool, executor: str, index=None):
    """The one kernel launch of a DRFS flush's tree phase: ``(name, args,
    kwargs)`` for ``ops.<name>``. ``tab`` is the block's window table as
    flat rows, read in place through ``index`` (a ``FlatIndex``): exact
    mode walks the complete tree (``fused_walk_flat``; ``dyn_node_walk_flat``
    for ``kernel``), quantized mode differences two leaf-prefix rows per
    atom with q_s ⊗ q_t built in-kernel (``fused_leaf_flat``;
    ``dyn_leaf_query_flat`` for ``kernel``). Leaf ranges are resolved from
    the grouped slots' position bounds (padding slots come out empty)."""
    G, Qp = entry["side"].shape
    leaf_lo, leaf_hi = _dyn_leaf_range(forest, entry["gfa"], hq)
    leaf_hi = torch.maximum(leaf_hi, leaf_lo)
    ranges = (leaf_lo.to(torch.int32).reshape(G, Qp), leaf_hi.to(torch.int32).reshape(G, Qp),
              entry["side"])
    qs = entry["qs"]
    kernel = executor == "kernel"
    if exact:
        return ("dyn_node_walk_flat" if kernel else "fused_walk_flat"), (tab, index, *ranges, qs), {}
    qtl = wb.qt[0::2].contiguous()
    qtr = wb.qt[1::2].contiguous()
    name = "dyn_leaf_query_flat" if kernel else "fused_leaf_flat"
    return name, (tab, index, *ranges, qs, qtl, qtr), {}


def _dyn_flush(forest, tab, index, entry, wb, heat, *, hq: int, exact: bool, executor: str):
    """ONE kernel launch for the block's tree phase ([G, Qp, W]), added
    onto heat [L, W] in place by the fixed-order scatter — only the real
    atoms' slots (``entry["gseg"]``)."""
    name, args, kwargs = dyn_kernel_call(forest, tab, entry, wb, hq=hq, exact=exact,
                                         executor=executor, index=index)
    out = getattr(ops, name)(*args, **kwargs)
    ops.segment_add(heat, out.reshape(-1, heat.shape[1]), entry["gseg"])


class _SealedPack:
    """Device tables for one sealed structure epoch (revision, depth)."""

    __slots__ = ("tables", "n_levels", "max_occ", "nbytes")


class _PendPack:
    """Device tables for one pending-buffer epoch (pend_revision)."""

    __slots__ = ("tables", "pend_steps", "nbytes")


class FlatDynamicEngine(_DeviceEngine):
    """Device-resident streaming query engine over a DynamicRangeForest.

    Promotes DRFS (§5) to the GPU: the implicit position-bisection tree is
    packed level-major into flat device tables (DESIGN.md §5) and every
    flush answers all W windows, exactly like :class:`FlatForestEngine` for
    the static forest. Streaming mutations stay on the host (drfs.py); this
    adapter packs **per snapshot**, keyed on the ``(revision,
    pend_revision)`` epochs (DESIGN.md §6):

      * every flush targets an explicit :class:`drfs.DrfsSnapshot` (the live
        head by default) — a query pinned to an old epoch keeps answering
        from its own pack while inserts/seals move the live forest (MVCC);
      * ``insert`` only bumps ``pend_revision`` — the next flush uploads the
        (small) pending CSR of the snapshot it serves and queries see new
        events through the device-side masked pending scan. No tree work;
      * ``seal`` / ``extend`` / eviction bump ``revision`` — the next flush
        on the new epoch uploads fresh level tables (event capacity padded
        to an ⅛-octave size class, as in the reference).

    Packs live in small LRU caches (``max_snapshots`` sealed epochs, a few
    pending epochs); an evicted epoch re-packs on demand from the snapshot's
    host arrays, so pinning older revisions trades device memory for upload
    time, never correctness.

    Executors: ``packed`` runs every phase in plain torch
    (:func:`eval_atoms_dyn`); ``fused`` answers the tree phase of each atom
    block with ONE kernel launch on the window table in place —
    ``fused_leaf`` in quantized mode, ``fused_walk`` over the complete tree
    in exact mode — and runs only the boundary-leaf and pending scans in
    plain torch; ``kernel`` does the same through ``dyn_leaf_query_flat``
    and ``dyn_node_walk_flat`` (the same kernels, counted as the kernel
    tier's). Both the quantized-H₀
    mode (partial boundary leaves dropped, paper §5.2) and the exact-leaf
    mode run on the device; scan work is accounted into the forest's
    counters host-side (same units as the NumPy path).

    ``codec`` (:class:`torch_engine.TableCodec`) sets the storage dtype of
    the window tables of every executor — the fold dtype for exact mode's
    node values, the moment dtype for quantized mode's delta-encoded leaf
    prefix — validated once, against the first sealed epoch's prefix
    moments (a failed round trip falls back to f64 in place:
    ``codec.fallback_reason``).
    """

    def __init__(self, df, *, max_snapshots: int = 2, executor: str = "packed",
                 device="cuda", codec="auto"):
        self._init_device(device)
        if executor in ("auto", None):
            executor = "packed"
        if executor not in ("packed", "fused", "kernel"):
            raise ValueError(f"unknown drfs executor {executor!r}")
        self.df = df
        self.executor = executor
        self.codec = TableCodec(codec)
        self._codec_checked = False
        self.max_snapshots = max(int(max_snapshots), 1)
        self._sealed_packs = OrderedDict()  # (revision, depth) -> _SealedPack
        self._pend_packs = OrderedDict()  # pend_revision -> _PendPack
        # (ts_key, revision, depth, hq, exact, codec) -> window tables
        self._tab_cache = OrderedDict()
        # plan.key -> device atom packs (epoch-independent: the atoms and the
        # grouped kernel layout derive from the plan's host blocks only)
        self._pack_cache = PlanCache(2)
        # hq -> [hq+1, E] complete-tree node bases of the exact-mode walk
        self._tree_base = {}
        snap = df.snapshot()
        self._get_sealed(snap)
        self._get_pending(snap)

    # ----------------------------------------------------------- packing
    def _get_sealed(self, snap) -> _SealedPack:
        """Sealed level tables for the snapshot's structure epoch (LRU)."""
        key = (snap.revision, snap.depth)
        pack = self._sealed_packs.get(key)
        if pack is not None:
            self._sealed_packs.move_to_end(key)
            return pack
        N = snap.n_sealed
        Lv = snap.depth + 1
        K = snap.ctx.K
        Np = _size_class(max(N, 1))
        time_lvl = np.full(Lv * Np, np.inf)
        pos_lvl = np.full(Lv * Np, np.inf)
        cum_lvl = np.zeros((Lv * Np, N_COMBOS, K))
        ptr_parts = []
        max_occ = np.zeros(Lv, np.int64)
        for d, (nptr, tms, cum, eidx) in enumerate(snap.levels):
            time_lvl[d * Np : d * Np + N] = tms
            pos_lvl[d * Np : d * Np + N] = snap.pos[eidx]
            cum_lvl[d * Np : d * Np + N] = cum
            ptr_parts.append(nptr)
            max_occ[d] = int(np.diff(nptr).max(initial=0))
        if not self._codec_checked:
            # build-time round trip of the f64 prefix moments: a codec that
            # cannot hold this forest degrades to f64 in place
            self.codec.validate(cum_lvl)
            self._codec_checked = True
        pack = _SealedPack()
        pack.tables = dict(
            time_lvl=self._f64(time_lvl),
            pos_lvl=self._f64(pos_lvl),
            cum_lvl=self._f64(cum_lvl),
            # int32 in the reference; torch gathers with int64 indices
            node_ptr=self._as(np.concatenate(ptr_parts), torch.int64),
            edge_len=self._f64(snap.lens),
        )
        pack.n_levels = Lv
        pack.max_occ = max_occ
        pack.nbytes = _device_nbytes(pack.tables)
        self._sealed_packs[key] = pack
        while len(self._sealed_packs) > self.max_snapshots:
            old_key, _ = self._sealed_packs.popitem(last=False)
            # drop window tables derived from the evicted structure epoch
            for tk in [k for k in self._tab_cache if k[1:3] == old_key]:
                del self._tab_cache[tk]
        return pack

    def release_stale(self, epoch) -> int:
        """Drop device packs (and their derived window tables) for epochs
        strictly older than ``epoch = (revision, pend_revision)``.

        The compactor calls this right after a horizon eviction, so a
        horizon-bounded stream's ``device_bytes`` plateaus instead of
        sawtoothing at LRU capacity. Safe with MVCC: a still-pinned snapshot
        that queries later re-packs from its own pinned arrays on the cache
        miss. Returns the number of packs dropped.
        """
        revision, pend_revision = epoch
        dropped = 0
        for key in [k for k in self._sealed_packs if k[0] < revision]:
            del self._sealed_packs[key]
            dropped += 1
            for tk in [k for k in self._tab_cache if k[1:3] == key]:
                del self._tab_cache[tk]
        for key in [k for k in self._pend_packs if k < pend_revision]:
            del self._pend_packs[key]
            dropped += 1
        return dropped

    @property
    def device_bytes(self) -> int:
        """Sealed + pending packs + cached window tables, tree node bases
        and atom packs — one accounting helper with the static engine."""
        return _device_nbytes(
            [
                list(self._sealed_packs.values()),
                list(self._pend_packs.values()),
                list(self._tab_cache.values()),
                list(self._tree_base.values()),
                list(self._pack_cache.values()),
            ]
        )

    @property
    def bytes_per_shard(self) -> int:
        """See :attr:`FlatForestEngine.bytes_per_shard` — one device, one shard."""
        return self.device_bytes

    def _get_pending(self, snap) -> _PendPack:
        """Pending-CSR tables for the snapshot's pending epoch (LRU)."""
        key = snap.pend_revision
        pack = self._pend_packs.get(key)
        if pack is not None:
            self._pend_packs.move_to_end(key)
            return pack
        E = snap.net.n_edges
        K = snap.ctx.K
        csr = snap.pending_csr()
        pack = _PendPack()
        if csr is None:
            pptr = np.zeros(E + 1, np.int64)
            pp = np.zeros(1)
            pt = np.full(1, np.inf)
            pf = np.zeros((1, N_COMBOS, K))
            pack.pend_steps = 0
        else:
            pptr, pp, pt, pf = csr
            pad = _size_class(len(pp), floor=64) - len(pp)
            if pad:
                pp = np.concatenate([pp, np.zeros(pad)])
                pt = np.concatenate([pt, np.full(pad, np.inf)])
                pf = np.concatenate([pf, np.zeros((pad,) + pf.shape[1:])])
            pack.pend_steps = next_pow2(int(np.diff(pptr).max(initial=1)))
        pack.tables = dict(
            pend_ptr=self._as(pptr, torch.int64),
            pend_pos=self._f64(pp),
            pend_time=self._f64(pt),
            pend_phi=self._f64(pf),
        )
        pack.nbytes = _device_nbytes(pack.tables)
        self._pend_packs[key] = pack
        while len(self._pend_packs) > self.max_snapshots + 2:
            self._pend_packs.popitem(last=False)
        return pack

    def _forest(self, sealed: _SealedPack, pend: _PendPack) -> FlatDynamicForest:
        return FlatDynamicForest(**sealed.tables, **pend.tables)

    # ------------------------------------------------------------ per query
    def window_tables(self, wb, ts_key, snap, sealed: _SealedPack, hq: int, exact: bool):
        """Window tables for (ts tuple, structure epoch, hq, mode), LRU-cached.

        The engine's core hoist: all per-node time searches (and the q_t
        contraction, in exact mode) are paid once per (window batch,
        structure epoch) at node-count scale, so every atom flush — and
        every WARM QUERY over the same centers — costs O(1) table gathers
        per atom. Quantized mode: leaf prefix tables
        (:func:`torch_engine.dyn_window_tables`); exact mode: node-value
        tables (:func:`torch_engine.dyn_node_tables`), stored in the codec's
        moment resp. fold dtype. They depend only on the sealed structure,
        never on the pending buffers.
        """
        key = (ts_key, snap.revision, snap.depth, int(hq), bool(exact), self.codec.name)
        hit = self._tab_cache.get(key)
        if hit is not None:
            self._tab_cache.move_to_end(key)
            return hit

        def steps(occ):
            return max(int(np.ceil(np.log2(int(occ) + 1))) + 1, 1)

        E = snap.net.n_edges
        W = len(ts_key)
        K = snap.ctx.K
        forest = self._forest(sealed, self._get_pending(snap))
        if exact:
            spl = tuple(steps(o) for o in sealed.max_occ[: hq + 1])
            tabs = (dyn_node_tables(forest, wb, n_levels=sealed.n_levels, hq=int(hq),
                                    steps_per_level=spl, out_dtype=self.codec.fold_dtype),)
            nn = E * ((1 << (hq + 1)) - 1)
        else:
            tabs = (dyn_window_tables(forest, wb, n_levels=sealed.n_levels, hq=int(hq),
                                      search_steps=steps(sealed.max_occ[hq]),
                                      out_dtype=self.codec.moment_dtype),)
            nn = E * (1 << hq)
        self.counters["rank_searches"] += 3 * W * nn
        self.counters["moment_gathers"] += 3 * W * nn
        # table folds gather raw-Φ prefix rows from the f64 level tables
        self.counters["bytes_moved"] += 3 * W * nn * N_COMBOS * K * 8
        self._tab_cache[key] = tabs
        while len(self._tab_cache) > 4 * self.max_snapshots:
            self._tab_cache.popitem(last=False)
        return tabs

    def _atom_packs(self, plan):
        """Device atom blocks for a HostPlan, LRU-cached per plan: the flat
        block (scan phases and the packed executor) and, for ``fused`` and
        ``kernel``, the per-edge grouped [G, Qp] layout the kernels read,
        already in their types (masked ``qs``, int32 sides) with the real
        atoms' slots."""
        hit = self._pack_cache.get(plan.key)
        if hit is not None:
            return hit
        packs = []
        for atoms in plan.blocks:
            entry = dict(fa=self._device_atoms(atoms, np.arange(atoms.m)), atoms=atoms, m=atoms.m,
                         seg=self._segments(atoms.lixel))
            if self.executor != "packed":
                _, cnt = np.unique(atoms.edge, return_counts=True)
                qp = _size_class(int(cnt.max(initial=1)), floor=16)
                edges, fields, _ = group_atoms_by_edge(atoms, q_pad=qp)
                G = len(edges)
                gfa = self._flat_atoms(
                    fields, np.broadcast_to(edges[:, None], fields["lixel"].shape)
                )
                slots = np.flatnonzero(fields["valid"])  # the real atoms' [G·Qp] slots
                entry.update(
                    edges=self._as(edges, torch.int64),
                    edges_host=np.asarray(edges, np.int64),  # host copy for range checks
                    index={},  # (hq, exact) -> FlatIndex, built by tree_table
                    gfa=gfa,
                    # the fixed-order scatter over the real atoms' slots
                    gseg=self._segments(fields["lixel"].reshape(-1)[slots], slots),
                    side=gfa.side_feat.reshape(G, qp),
                    qs=(gfa.qs * gfa.valid[:, None]).reshape(G, qp, -1),
                )
            packs.append(entry)
        self._pack_cache.put(plan.key, packs)
        return packs

    def tree_table(self, tables, entry, *, hq: int, exact: bool):
        """``(tab, index)`` for :func:`dyn_kernel_call`: the block's window
        table as flat rows (a view, no copy) with its ``FlatIndex``, built
        and range-checked once per block and (hq, mode) and cached on the
        entry — exact mode reads the complete tree through
        ``dyn_node_base(E, hq)`` (cached per hq), quantized mode the leaf
        table through ``leaf_index(edges, 2^hq)``. Every executor reads the
        same flat tables. The range check reads the host copies of the edges
        and node bases kept beside them, so building an index never waits
        for the card."""
        (tab,) = tables
        E, hq = self.df.net.n_edges, int(hq)
        index = entry["index"].get((hq, bool(exact)))
        if index is None:
            if exact:
                base = self._tree_base.get(hq)
                if base is None:  # (device, host) node bases
                    host = dyn_node_base(E, hq).numpy()
                    base = self._tree_base[hq] = (self._as(host, torch.int64), host)
                index = ops.walk_index(base[0], entry["edges"], 1 << hq, lvl_base_host=base[1],
                                       edges_host=entry["edges_host"])
            else:
                index = ops.leaf_index(entry["edges"], 1 << hq, edges_host=entry["edges_host"])
            entry["index"][(hq, bool(exact))] = index
        return tab.reshape(tab.shape[0], -1), index

    def flush_plan(self, heat, plan, wb, ts_key, *, h0=None, exact_leaf=False,
                   snapshot=None, **_):
        """heat[L, W] += every atom block of the plan, snapshot-consistent.

        Packs (or re-uses) the device tables of the targeted snapshot's
        epoch, then answers the fully-covered leaf ranges from the cached
        window tables plus boundary/pending scans, per atom block.
        ``snapshot=None`` pins the live head.
        """
        if plan.n_atoms == 0:
            return heat
        snap = snapshot if snapshot is not None else self.df.snapshot()
        sealed = self._get_sealed(snap)
        pend = self._get_pending(snap)
        hq = snap.depth if h0 is None else min(int(h0), snap.depth)
        exact = bool(exact_leaf)
        scan_steps = 0
        if exact:
            # next multiple of 8 over the max leaf occupancy, as the
            # reference (its recompile bound); the answer does not depend on it
            occ = int(sealed.max_occ[hq])
            scan_steps = -(-occ // 8) * 8 if occ else 0
        W = heat.shape[1]
        tables = self.window_tables(wb, ts_key, snap, sealed, hq, exact)
        forest = self._forest(sealed, pend)
        K = snap.ctx.K
        k_s = snap.ctx.k_s
        # exact mode walks codec-sized node-value rows [W, 2k_s]; quantized
        # mode differences two codec-sized leaf-prefix rows [W, 2K] per atom
        row_bytes = (W * 2 * k_s * self.codec.fold_itemsize if exact
                     else W * 2 * K * self.codec.moment_itemsize)
        scan_kw = dict(n_levels=sealed.n_levels, hq=int(hq), scan_steps=int(scan_steps),
                       pend_steps=int(pend.pend_steps), exact=exact)
        for entry in self._atom_packs(plan):
            atoms = entry["atoms"]
            # work accounting (same units as the NumPy scans: (atom, event)
            # pairs examined, per half-window for partials / window pending)
            snap.counters["pending"] += snap.pending_scan_pairs(atoms) * W
            if exact:
                snap.counters["partial"] += snap.partial_scan_pairs(atoms, hq) * 2 * W
            gathers = 2 * (hq + 1) * entry["m"] if exact else 2 * entry["m"]
            self.counters["moment_gathers"] += gathers
            self.counters["bytes_moved"] += gathers * row_bytes
            if self.executor == "packed":
                _dyn_plain_flush(forest, entry["fa"], entry["seg"], wb, tables, heat, **scan_kw)
                continue
            # tree phase: ONE kernel launch; scans stay in plain torch
            tab, index = self.tree_table(tables, entry, hq=int(hq), exact=exact)
            _dyn_flush(forest, tab, index, entry, wb, heat, hq=int(hq), exact=exact,
                       executor=self.executor)
            if self.executor == "fused":
                self.counters["fused_launches"] += 1
            if scan_steps or pend.pend_steps:
                _dyn_plain_flush(forest, entry["fa"], entry["seg"], wb, (), heat, tree=False,
                                 **scan_kw)
        return heat
