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
tables per ts tuple, and two executors over the same position-major tables —
the gather-lean ``packed`` walk in plain torch (default) and ``fused``, ONE
hand-written CUDA ``fused_walk`` launch per flush
(``repro_torch.kernels.fused_walk``).
"""
from __future__ import annotations

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
from .plan import AtomSet
from .query_plan import PlanCache, group_atoms_by_edge
from .torch_engine import (
    FlatAtoms,
    WindowBatch,
    eval_atoms_packed,
    packed_forest_from_numpy,
    packed_node_tables,
    packed_root_ranks,
)

__all__ = [
    "RangeForest",
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


def _device_nbytes(obj) -> int:
    """Total bytes of every device tensor reachable from ``obj`` — the ONE
    accounting helper for engine tables, atom packs and packed plans
    (accepts tensors, NamedTuples, dicts and lists/tuples; anything else
    counts 0)."""
    if hasattr(obj, "element_size"):
        return int(obj.numel()) * obj.element_size()
    if isinstance(obj, dict):
        return sum(_device_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_device_nbytes(v) for v in obj)
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
        # executors dispatch. fused_launches counts fused_walk kernel
        # launches (the fused executor pays exactly ONE per atom pack).
        self.counters = {
            "rank_searches": 0,
            "moment_gathers": 0,
            "bytes_moved": 0,
            "fused_launches": 0,
        }

    def _f64(self, x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64), device=self.device)

    def _as(self, x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device).to(dtype)

    def window_batch(self, ctx: MomentContext, ts):
        """Device WindowBatch for the ts tuple, LRU-cached — repeated queries
        over the same centers reuse one device object (and everything keyed
        on it downstream: node values, grouped node values)."""
        ts_key = tuple(float(t) for t in ts)
        hit = self._wb_cache.get(ts_key)
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


def _rfs_group(nodeval, node_base_lvl, edges, *, npad: int, nlev: int):
    """Per-edge grouped node values from the flat packed tables: [G, R2, W·C].

    The packed build lays an edge's level-ℓ rows contiguously at
    [node_base[e, ℓ]·2, node_base[e, ℓ]·2 + 2·(npad >> ℓ)), so the fused
    kernel's per-edge blocks are per-level slices stacked in walk-level
    order. Depends only on (window tables, plan edges) — both stable across
    warm flushes — so the engine caches the result alongside the window
    tables.
    """
    G = edges.shape[0]
    W, C = nodeval.shape[1], nodeval.shape[2]
    parts = []
    for lev in range(nlev):
        nb = npad >> lev
        base = node_base_lvl[lev][edges]  # [G]
        idx = base[:, None] * 2 + torch.arange(nb * 2, device=edges.device)[None, :]
        parts.append(nodeval[idx])  # [G, nb·2, W, C]
    nv = torch.cat(parts, dim=1)
    return nv.reshape(G, nv.shape[1], W * C)


def _rfs_flush(nv_g, entry, heat):
    """ONE fused kernel launch: walk + window contraction, scattered onto
    heat [L, W] in place. Padding slots of the [G, Qp] layout carry qs = 0
    and an empty interval, so the kernel writes exact zeros there; only the
    real atoms' rows (``entry["rows"]``) are scattered."""
    W = heat.shape[1]
    out = ops.fused_walk(
        nv_g, entry["r_lo"], entry["r_hi"], entry["side"], entry["qs"],
        offs=entry["offs"],
    )  # [G, W, Qp]
    flat = out.permute(0, 2, 1).reshape(-1, W)
    _scatter_add(heat, entry["lixel"], flat.index_select(0, entry["rows"]))


def _scatter_add(heat, lixel, rows):
    """heat[lixel[m], :] += rows[m, :] in place. ``index_put_`` with
    ``accumulate=True`` rather than ``index_add_``: on CUDA it sorts the
    indices and adds the duplicates of a lixel in one fixed order for every
    window column, so duplicate window centers stay bitwise identical and
    two runs give the same bits; ``index_add_`` uses atomics, whose order
    changes from column to column and from run to run."""
    heat.index_put_((lixel,), rows, accumulate=True)


class FlatForestEngine(_DeviceEngine):
    """Device-resident window-batched query engine over a built RangeForest.

    Solves the multiple-temporal-KDE hot loop (§8.2) on the GPU with two
    interchangeable executors over the packed query plan (DESIGN.md §7):

      executor='packed'   (default) gather-lean plain-torch executor:
                          position-major node tables with q_t folded in,
                          built ONCE per (snapshot, window batch) and
                          LRU-cached; atoms carry cached root rank intervals,
                          so a steady-state flush is one canonical walk with
                          one paired gather per level — no searches at all.
      executor='fused'    ONE hand-written CUDA launch per atom pack: the
                          whole canonical walk + window contraction runs
                          in-kernel over per-edge grouped node values
                          (kernels/fused_walk.py).

    Both answer all W windows per flush into a device-resident [L, W]
    heatmap (float64 — exactness is part of the paper's claim), transferred
    once per query. ``device`` defaults to ``'cuda'``; with no card the
    constructor raises (pass ``device='cpu'`` for the plain-torch path).
    """

    def __init__(self, rf: RangeForest, *, executor: str = "packed",
                 device="cuda", host_tables: dict = None):
        self._init_device(device)
        if executor in ("auto", None):
            executor = "packed"
        if executor not in ("packed", "fused"):
            raise ValueError(f"unknown rfs executor {executor!r}")
        self.rf = rf
        self.executor = executor
        self.max_levels = max(rf.max_levels, 1)
        npmax = max(int(rf.n_pad.max(initial=1)), 1)
        nemax = max(int(np.diff(rf.ee.ptr).max(initial=1)), 1)
        self.search_steps = max(int(np.ceil(np.log2(max(npmax, nemax) + 1))) + 1, 1)
        self._tab_cache = PlanCache(2)  # ts_key -> window tables (plans)
        self._pack_cache = PlanCache(2)  # plan.key -> device atom packs
        # (ts_key, plan.key, block) -> per-edge grouped node values (fused)
        self._group_cache = PlanCache(8)
        host = build_packed_host_tables(rf) if host_tables is None else host_tables
        pf, meta = packed_forest_from_numpy(host, self.device)
        self._packed = dict(pf=pf, **meta)

    @classmethod
    def from_host_tables(cls, rf: RangeForest, host: dict, *,
                         executor: str = "packed", device="cuda"):
        """Engine over index state built elsewhere: ``host`` is the dict
        ``build_packed_host_tables`` returns (this package's or the
        reference's); ``rf`` supplies the block sizes and the context."""
        return cls(rf, executor=executor, device=device, host_tables=host)

    @property
    def device_bytes(self) -> int:
        """Index tables + cached packed plans (atom packs, window tables,
        grouped node values)."""
        return _device_nbytes(
            [
                self._packed,
                list(self._tab_cache.values()),
                list(self._pack_cache.values()),
                list(self._group_cache.values()),
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

        packed: per block, per LEVEL class (edge tree depth rounded up to
        multiples of 3, so shallow-edge atoms never walk the deepest edge's
        level count). fused: per block, per NPAD class (:meth:`_fused_pack`).
        """
        key = (plan.key, self.executor)
        hit = self._pack_cache.get(key)
        if hit is not None:
            return hit
        packs = []
        for atoms in plan.blocks:
            if self.executor == "fused":
                packs.extend(self._fused_pack(atoms))
                continue
            nl = self.rf.n_levels[atoms.edge]
            cls = np.minimum(-(-nl // 3) * 3, self.max_levels).astype(np.int64)
            for c in np.unique(cls):
                sel = np.nonzero(cls == c)[0]
                fa = self._device_atoms(atoms, sel)
                r_lo, r_hi = packed_root_ranks(
                    self._packed["pf"], fa, search_steps=self.search_steps
                )
                packs.append(
                    dict(max_levels=int(c), fa=fa, m=len(sel), r_lo=r_lo, r_hi=r_hi)
                )
        self._pack_cache.put(key, packs)
        return packs

    def _fused_pack(self, atoms):
        """Per-edge grouped packed-plan layout for the fused executor: one
        entry per NPAD size class (so every group in a launch shares its
        node-row count), with the window-independent root rank intervals
        searched once per plan and cached on the entry — the fused kernel's
        only remaining inputs are the ts-keyed grouped node values. The
        entry keeps just what a flush reads, already in the kernel's types:
        masked ``qs`` (padding rows zeroed), int32 ranks and sides."""
        rf = self.rf
        entries = []
        npad_of = rf.n_pad[atoms.edge]
        for p in np.unique(npad_of):
            sel = np.nonzero(npad_of == p)[0]
            sub = atoms.take(sel)
            _, cnt = np.unique(sub.edge, return_counts=True)
            qp = _size_class(int(cnt.max(initial=1)), floor=16)
            edges, fields, _ = group_atoms_by_edge(sub, q_pad=qp)
            p_i, nlev = int(p), int(p).bit_length()
            # walk level ℓ of an edge block holds npad >> ℓ node rows; the
            # kernel's static offs are their cumulative starts (node units)
            offs, o = [], 0
            for lev in range(nlev):
                offs.append(o)
                o += p_i >> lev
            G = len(edges)
            fa = self._flat_atoms(
                fields, np.broadcast_to(edges[:, None], fields["lixel"].shape)
            )
            r_lo, r_hi = packed_root_ranks(
                self._packed["pf"], fa, search_steps=self.search_steps
            )
            rows = torch.nonzero(fa.valid).reshape(-1)
            entries.append(
                dict(
                    edges=self._as(edges, torch.int64),
                    # flat [G·Qp] slots of the real atoms, and their lixels
                    rows=rows,
                    lixel=fa.lixel.index_select(0, rows),
                    side=fa.side_feat.reshape(G, qp),
                    qs=(fa.qs * fa.valid[:, None]).reshape(G, qp, -1),
                    r_lo=r_lo.reshape(G, qp),
                    r_hi=r_hi.reshape(G, qp),
                    offs=tuple(offs),
                    npad=p_i,
                    m=sub.m,
                    max_levels=nlev,
                )
            )
        return entries

    def window_tables(self, wb, ts_key):
        """Per-(window batch) derived tables, LRU-cached by the ts tuple:
        q_t-folded paired node values (the plan's core hoist — every time
        search and every per-node prefix gather happens HERE, at node count
        scale, never per atom)."""
        key = (ts_key, self.executor)
        hit = self._tab_cache.get(key)
        if hit is not None:
            return hit
        W = len(ts_key)
        K = self.rf.ctx.K
        pk = self._packed
        tabs = packed_node_tables(
            pk["pf"], wb, pk["node_starts"],
            steps_per_level=pk["steps_per_level"], k_t=int(self.rf.ctx.k_t),
        )
        nn = max(pk["n_nodes"], 1)
        self.counters["rank_searches"] += 3 * W * nn
        self.counters["moment_gathers"] += 3 * W * nn
        # fold gathers read paired raw-Φ prefix rows from the f64 tables
        self.counters["bytes_moved"] += 3 * W * nn * N_COMBOS * K * 8
        self._tab_cache.put(key, tabs)
        return tabs

    # ------------------------------------------------------------ per query
    def flush_plan(self, heat, plan, wb, ts_key, **_):
        """heat[L, W] += every atom block of the plan, all W windows.

        All window-dependent tables come from the ts-keyed cache, all
        atom-side state from the plan's pack cache — in steady state the
        only work left is the walks (packed) or one launch per pack (fused).
        """
        if plan.n_atoms == 0:
            return heat
        tabs = self.window_tables(wb, ts_key)
        packs = self._atom_packs(plan)
        W = len(ts_key)
        k_s = self.rf.ctx.k_s
        # the per-atom walk gathers q_t-folded node-value rows [W, 2k_s] f64
        row_bytes = W * 2 * k_s * 8
        pk = self._packed
        for bi, entry in enumerate(packs):
            c, m = entry["max_levels"], entry["m"]
            if self.executor == "packed":
                fa = entry["fa"]
                vals = eval_atoms_packed(
                    tabs, pk["node_base_lvl"], fa, entry["r_lo"], entry["r_hi"],
                    max_levels=c,
                )  # [Wh, M]
                per_win = vals[0::2] + vals[1::2]  # fold window halves
                _scatter_add(heat, fa.lixel, per_win.T)
            else:
                gkey = (ts_key, plan.key, bi)
                nv_g = self._group_cache.get(gkey)
                if nv_g is None:
                    nv_g = _rfs_group(
                        tabs, pk["node_base_lvl"], entry["edges"],
                        npad=entry["npad"], nlev=c,
                    )
                    self._group_cache.put(gkey, nv_g)
                _rfs_flush(nv_g, entry, heat)
                # ONE kernel launch answered the whole pack; the walk still
                # touches the same node rows
                self.counters["fused_launches"] += 1
            self.counters["moment_gathers"] += 2 * c * m
            self.counters["bytes_moved"] += 2 * c * m * row_bytes
        return heat
