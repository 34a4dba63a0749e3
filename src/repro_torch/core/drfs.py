"""Dynamic Range Forest Solution (paper §5), dense-array form.

DRFS replaces RFS's rank-based splits with *real-position* bisection so the
structure is known before the data arrives — that is what makes streaming
insertion possible (§5.1) and gives the accuracy/size dial H (§5.2).

Dense-array form (DESIGN.md §2/§5): per edge, an implicit position-bisection
tree of depth H over [0, len_e] (node (d, i) covers the i-th 1/2^d fraction).
Every node stores its events in arrival = time order with inclusive prefix
sums of the moment block Φ — each event appears on its root-to-leaf path, so
construction is O(n_e · H) time and space (Lemma 5.1); adding one more depth
level ("extension operation", Algorithm 4) costs O(n_e), and streaming
inserts append to pending buffers that queries scan linearly until a
geometric ``seal`` merges them.

``seal`` is **incremental**: only *dirty* edges (those holding pending
events) are re-aggregated; clean edges' per-level runs are spliced over
unchanged (their node counts cannot change), so a seal costs a flat memcpy
plus O(n_dirty · H) sort/cumsum work instead of O(N · H) rebuild work.

Queries map a position interval to fully-covered leaves at depth
H_q = min(H, H_0), canonically decompose that leaf range (<= 2 nodes per
level, the same walk as rfs.py), and resolve the *time* window with two
binary searches per node (events inside a node are time-sorted).

**Snapshot isolation (MVCC, DESIGN.md §6).** Every mutation allocates fresh
arrays and rebinds — ``seal`` builds new base/level arrays, ``extend``
appends a new level tuple, ``insert`` lands in pending buffers whose CSR is
materialized per ``pend_revision``. ``snapshot()`` therefore pins a
consistent point-in-time view by *reference*: a ``DrfsSnapshot`` holds the
sealed arrays, a frozen copy of the level list, and the materialized pending
CSR, identified by the ``(revision, pend_revision)`` epoch pair. All query
methods live on the shared ``_DrfsQueryView`` mixin, so a pinned snapshot
answers queries with the exact event set visible at pin time while inserts,
seals and extends proceed on the live forest (``TNKDE.query(ts, at=snap)``).

  * quantized mode (paper §5.2): partially covered boundary leaves at depth
    H_q are dropped (the paper's "return a zero-vector"); accuracy rises with
    H_0 exactly as Figure 20.
  * ``exact_leaf_scan`` (testing convenience, beyond paper): boundary leaves
    are scanned event-by-event, making DRFS exact — used to validate the
    machinery against the SPS oracle.

The device-resident query engine over this structure is
``rfs.FlatDynamicEngine`` / ``torch_engine.eval_atoms_dyn``; mutations happen
here on the host and the engine re-packs lazily, keyed on ``revision`` /
``pend_revision``. This module is NumPy only: index state built by the
reference package's ``DynamicRangeForest`` loads here unchanged through
:meth:`DynamicRangeForest.load_state` (the ``state_tree()`` dict of arrays).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .aggregation import MomentContext, segmented_cumsum, segmented_searchsorted
from .events import EdgeEvents, group_by_edge_csr, ragged_arange
from .network import RoadNetwork
from .plan import AtomSet

__all__ = ["DynamicRangeForest", "DrfsSnapshot"]


class _DrfsQueryView:
    """Query-side methods shared by the live forest and pinned snapshots.

    Requires: ``ctx``, ``depth``, ``levels``, ``lens``, ``pos``, ``time``,
    ``phi``, ``counters``, ``_n_pending`` and ``pending_csr()``.
    """

    # -------------------------------------------------------------- queries
    def eval_atoms(
        self,
        atoms: AtomSet,
        t: float,
        *,
        h0: Optional[int] = None,
        exact_leaf_scan: bool = False,
        **_,
    ) -> np.ndarray:
        M = atoms.m
        if M == 0:
            return np.zeros(0)
        ctx = self.ctx
        hq = self.depth if h0 is None else min(h0, self.depth)
        qt = (ctx.qt_left(t), ctx.qt_right(t))
        t_bounds = ((t - ctx.b_t, t), (t, t + ctx.b_t))
        leaf_lo, leaf_hi = self.leaf_range(atoms, hq)
        out = np.zeros(M)
        for w in (0, 1):
            q_full = (atoms.qs[:, :, None] * qt[w][None, :]).reshape(M, -1)
            combo = atoms.side_feat.astype(np.int64) * 2 + w
            out += self._decompose(atoms, leaf_lo, leaf_hi, hq, t_bounds[w], combo, q_full, w)
            if exact_leaf_scan:
                out += self._scan_partials(
                    atoms, leaf_lo, leaf_hi, hq, t_bounds[w], combo, q_full, w
                )
        if self._n_pending:
            out += self._scan_pending(atoms, t, qt)
        return out

    def leaf_range(self, atoms: AtomSet, hq: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fully-covered leaf range [leaf_lo, leaf_hi) at depth hq, per atom."""
        lens = self.lens[atoms.edge]
        nleaf = 1 << hq
        w_leaf = lens / nleaf
        hi_ok = np.minimum(np.floor(atoms.pos_hi / w_leaf), nleaf).astype(np.int64)
        hi_ok = np.where(atoms.pos_hi >= lens, nleaf, np.maximum(hi_ok, 0))
        lo1 = np.asarray(atoms.pos_lo1, np.float64)
        lo2 = np.asarray(atoms.pos_lo2, np.float64)
        lo1_leaf = np.where(
            np.isfinite(lo1),
            np.where(
                atoms.lo1_right,
                np.floor(lo1 / w_leaf) + 1,  # need leaf start strictly > lo1
                np.ceil(lo1 / w_leaf),
            ),
            0,
        ).astype(np.int64)
        lo2_leaf = np.where(np.isfinite(lo2), np.ceil(lo2 / w_leaf), 0).astype(np.int64)
        leaf_lo = np.clip(np.maximum(lo1_leaf, lo2_leaf), 0, nleaf)
        leaf_hi = np.clip(hi_ok, 0, nleaf)
        return leaf_lo, leaf_hi

    # canonical decomposition over the leaf range; per emitted node, resolve
    # the time window with two binary searches in that node's time-sorted run.
    def _decompose(self, atoms, leaf_lo, leaf_hi, hq, tb, combo, q_full, w):
        M = atoms.m
        out = np.zeros(M)
        l = leaf_lo.astype(np.int64).copy()
        r = np.maximum(leaf_hi.astype(np.int64), l)
        eid = atoms.edge
        for lev in range(hq + 1):
            active = l < r
            if not active.any():
                break
            d = hq - lev  # actual tree depth of buckets at this step
            node_ptr, time_s, cum, _ = self.levels[d]
            for side in (0, 1):
                if side == 0:
                    emit = active & ((l & 1) == 1)
                    b = l
                else:
                    emit = active & ((r & 1) == 1)
                    b = r - 1
                idx = np.nonzero(emit)[0]
                if len(idx):
                    node = eid[idx] * (1 << d) + b[idx]
                    out[idx] += self._node_window_dot(
                        node_ptr, time_s, cum, node, idx, tb, combo, q_full, w
                    )
            l = np.where(active & ((l & 1) == 1), l + 1, l) >> 1
            r = np.where(active & ((r & 1) == 1), r - 1, r) >> 1
            if lev == hq:
                break
        return out

    def _node_window_dot(self, node_ptr, time_s, cum, node, idx, tb, combo, q_full, w):
        n = len(idx)
        s_lo = node_ptr[node]
        s_hi = node_ptr[node + 1]
        t0, t1 = tb
        # left half-window [t-b_t, t] has an inclusive lower bound ('left');
        # right half-window (t, t+b_t] has an exclusive one ('right' on t0)
        i_lo = segmented_searchsorted(
            time_s, s_lo, s_hi, np.full(n, t0), np.full(n, w == 1, dtype=bool)
        )
        i_hi = segmented_searchsorted(time_s, s_lo, s_hi, np.full(n, t1), np.ones(n, bool))
        i_hi = np.maximum(i_hi, i_lo)
        c = combo[idx]

        def pref(i):
            v = cum[np.maximum(i - 1, 0), c]
            return np.where((i > s_lo)[:, None], v, 0.0)

        mom = pref(i_hi) - pref(i_lo)
        return np.einsum("mk,mk->m", q_full[idx], mom)

    def partial_leaf_targets(self, atoms, leaf_lo, leaf_hi, hq):
        """(idx, node) pairs of the <= 2 partially covered boundary leaves
        each atom must scan in exact mode, deduplicated. Shared by the host
        scan and the device engine's work accounting."""
        M = atoms.m
        nleaf = 1 << hq
        lens = self.lens[atoms.edge]
        w_leaf = lens / nleaf
        # an event outside the fully-covered range [leaf_lo, leaf_hi) can only
        # pass the bounds if it sits in the leaf containing max(lo1, lo2) or
        # the leaf containing pos_hi — scan exactly those (deduplicated).
        lo_eff = np.maximum(
            np.where(np.isfinite(atoms.pos_lo1), atoms.pos_lo1, -np.inf),
            np.where(np.isfinite(atoms.pos_lo2), atoms.pos_lo2, -np.inf),
        )
        cl = np.where(
            np.isfinite(lo_eff), np.clip(np.floor(lo_eff / w_leaf), 0, nleaf - 1), -1
        ).astype(np.int64)
        cu = np.where(
            atoms.pos_hi >= lens,
            -1,
            np.clip(np.floor(np.maximum(atoms.pos_hi, 0.0) / w_leaf), -1, nleaf - 1),
        ).astype(np.int64)
        cu = np.where(atoms.pos_hi < 0, -1, cu)
        lo_c = np.clip(leaf_lo, 0, nleaf)
        hi_c = np.clip(leaf_hi, 0, nleaf)
        ok_cl = (cl >= 0) & (cl < lo_c)
        # scan cu when it is not inside the fully-covered range; dedup vs cl
        ok_cu = (cu >= 0) & ((cu < lo_c) | (cu >= hi_c)) & ~(ok_cl & (cu == cl))
        pairs = []
        for leaf, ok in ((cl, ok_cl), (cu, ok_cu)):
            idx = np.nonzero(ok)[0]
            if len(idx):
                pairs.append((idx, atoms.edge[idx] * nleaf + leaf[idx]))
        return pairs

    def partial_scan_pairs(self, atoms, hq) -> int:
        """Number of (atom, event) pairs one exact-mode boundary scan visits."""
        leaf_lo, leaf_hi = self.leaf_range(atoms, hq)
        node_ptr = self.levels[hq][0]
        total = 0
        for _, node in self.partial_leaf_targets(atoms, leaf_lo, leaf_hi, hq):
            total += int((node_ptr[node + 1] - node_ptr[node]).sum())
        return total

    def pending_scan_pairs(self, atoms) -> int:
        """Number of (atom, pending-event) pairs one pending scan visits."""
        if not self._n_pending:
            return 0
        pptr = self.pending_csr()[0]
        return int((pptr[atoms.edge + 1] - pptr[atoms.edge]).sum())

    def _scan_partials(self, atoms, leaf_lo, leaf_hi, hq, tb, combo, q_full, w):
        """Exact mode: scan the (<= 3) partially covered boundary leaves."""
        node_ptr, time_s, cum, ev_order = self.levels[hq]
        out = np.zeros(atoms.m)
        for idx, node in self.partial_leaf_targets(atoms, leaf_lo, leaf_hi, hq):
            s_lo = node_ptr[node]
            s_hi = node_ptr[node + 1]
            counts = (s_hi - s_lo).astype(np.int64)
            self.counters["partial"] += int(counts.sum())
            if counts.sum() == 0:
                continue
            rep_atom = np.repeat(idx, counts)
            ev = ragged_arange(s_lo, counts)
            ev_abs = ev_order[ev]
            p = self.pos[ev_abs]
            te = self.time[ev_abs]
            keep = ((te >= tb[0]) if w == 0 else (te > tb[0])) & (te <= tb[1])
            keep &= _pos_mask(atoms, rep_atom, p)
            if not keep.any():
                continue
            rep_atom, ev_abs = rep_atom[keep], ev_abs[keep]
            contrib = np.einsum(
                "mk,mk->m", q_full[rep_atom], self.phi[ev_abs, combo[rep_atom]]
            )
            np.add.at(out, rep_atom, contrib)
        return out

    def _scan_pending(self, atoms, t, qt):
        ctx = self.ctx
        pptr, pp_s, pt_s, pf_s = self.pending_csr()
        counts = (pptr[atoms.edge + 1] - pptr[atoms.edge]).astype(np.int64)
        total = int(counts.sum())
        self.counters["pending"] += total
        out = np.zeros(atoms.m)
        if total == 0:
            return out
        rep_atom = np.repeat(np.arange(atoms.m), counts)
        ev = ragged_arange(pptr[atoms.edge], counts)
        ok_pos = _pos_mask(atoms, rep_atom, pp_s[ev])
        for w, (t0, t1) in enumerate(((t - ctx.b_t, t), (t, t + ctx.b_t))):
            q_full = (atoms.qs[:, :, None] * qt[w][None, :]).reshape(atoms.m, -1)
            combo = atoms.side_feat.astype(np.int64) * 2 + w
            te = pt_s[ev]
            keep = ok_pos & ((te >= t0) if w == 0 else (te > t0)) & (te <= t1)
            sel = np.nonzero(keep)[0]
            if not len(sel):
                continue
            ra = rep_atom[sel]
            contrib = np.einsum("mk,mk->m", q_full[ra], pf_s[ev[sel], combo[ra]])
            np.add.at(out, ra, contrib)
        return out

    # ------------------------------------------------- LS support (§6 root)
    def dominated_moments_multi(self, edges: np.ndarray, ts: np.ndarray, side: int) -> np.ndarray:
        """LS root-node shortcut, window-batched: M [W, n, k_s] such that
        F_e(q) = Q_s(d(q, v_side)) · M[w] for a dominated edge (§6.2).

        Covers the **pending buffers** too — a dominated edge's contribution
        must include unsealed streamed events (depth-0 node = whole edge,
        O(1) per sealed edge; pending pairs are scanned and counted).
        """
        ctx = self.ctx
        edges = np.asarray(edges, np.int64)
        ts = np.asarray(ts, np.float64)
        n, W = len(edges), len(ts)
        node_ptr, time_s, cum, _ = self.levels[0]
        qt = np.stack(
            [[ctx.qt_left(t) for t in ts], [ctx.qt_right(t) for t in ts]], axis=1
        )  # [W, 2, k_t]
        M = np.zeros((W, n, ctx.k_s))
        s_lo = np.tile(node_ptr[edges], W)
        s_hi = np.tile(node_ptr[edges + 1], W)
        t_rep = np.repeat(ts, n)
        i_lo = segmented_searchsorted(time_s, s_lo, s_hi, t_rep - ctx.b_t, np.zeros(W * n, bool))
        i_mid = segmented_searchsorted(time_s, s_lo, s_hi, t_rep, np.ones(W * n, bool))
        i_hi = segmented_searchsorted(time_s, s_lo, s_hi, t_rep + ctx.b_t, np.ones(W * n, bool))

        for w_half, (r_lo, r_hi) in enumerate(((i_lo, i_mid), (i_mid, i_hi))):
            c = side * 2 + w_half
            r_hi = np.maximum(r_hi, r_lo)

            def pref(i):
                v = cum[np.maximum(i - 1, 0), c]
                return np.where((i > s_lo)[:, None], v, 0.0)

            mom = (pref(r_hi) - pref(r_lo)).reshape(W, n, ctx.k_s, ctx.k_t)
            M += np.einsum("wnst,wt->wns", mom, qt[:, w_half])

        if self._n_pending:
            pptr, _, pt_s, pf_s = self.pending_csr()
            counts = (pptr[edges + 1] - pptr[edges]).astype(np.int64)
            total = int(counts.sum())
            self.counters["pending"] += total * W
            if total:
                rep = np.repeat(np.arange(n), counts)
                ev = ragged_arange(pptr[edges], counts)
                te = pt_s[ev]
                for w in range(W):
                    t = ts[w]
                    for w_half, (t0, t1) in enumerate(((t - ctx.b_t, t), (t, t + ctx.b_t))):
                        keep = ((te >= t0) if w_half == 0 else (te > t0)) & (te <= t1)
                        sel = np.nonzero(keep)[0]
                        if not len(sel):
                            continue
                        mom = pf_s[ev[sel], side * 2 + w_half].reshape(-1, ctx.k_s, ctx.k_t)
                        np.add.at(M[w], rep[sel], mom @ qt[w, w_half])
        return M

    def dominated_moments(self, edges: np.ndarray, t: float, side: int) -> np.ndarray:
        """Single-window form of :meth:`dominated_moments_multi`: [n, k_s]."""
        return self.dominated_moments_multi(edges, np.array([float(t)]), side)[0]


class DrfsSnapshot(_DrfsQueryView):
    """Immutable point-in-time view of a :class:`DynamicRangeForest` (MVCC).

    Pins the sealed arrays by reference (mutations allocate fresh arrays and
    rebind, never writing in place), freezes the level list, and materializes
    the pending CSR, so a query against the snapshot observes exactly the
    event set visible when it was taken — concurrent ``insert`` / ``seal`` /
    ``extend`` on the live forest cannot tear it. The ``(revision,
    pend_revision)`` epoch pair is the snapshot's identity and the device
    engine's pack-cache key. ``counters`` is shared with the live forest:
    scan-work accounting stays a global roll-up.
    """

    def __init__(self, df: "DynamicRangeForest"):
        self.net = df.net
        self.ctx = df.ctx
        self.depth = df.depth
        self.lens = df.lens
        self.ptr = df.ptr
        self.pos = df.pos
        self.time = df.time
        self.phi = df.phi
        self.levels = tuple(df.levels)
        self.revision = df.revision
        self.pend_revision = df.pend_revision
        self.counters = df.counters
        self._csr = df.pending_csr()
        self._n_pending = df._n_pending

    @property
    def epoch(self) -> Tuple[int, int]:
        return (self.revision, self.pend_revision)

    @property
    def n_sealed(self) -> int:
        return int(self.pos.shape[0])

    @property
    def n_pending(self) -> int:
        return int(self._n_pending)

    def pending_csr(self):
        return self._csr

    def event_set(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(edge, pos, time) of every event visible at this snapshot —
        sealed first (per-edge time order), then pending. The oracle-side
        view serving tests rebuild fresh indices from."""
        E = self.net.n_edges
        parts_e = [np.repeat(np.arange(E, dtype=np.int64), np.diff(self.ptr))]
        parts_p = [self.pos]
        parts_t = [self.time]
        if self._csr is not None:
            pptr, pp, pt, _ = self._csr
            parts_e.append(np.repeat(np.arange(E, dtype=np.int64), np.diff(pptr)))
            parts_p.append(pp)
            parts_t.append(pt)
        return (
            np.concatenate(parts_e),
            np.concatenate(parts_p),
            np.concatenate(parts_t),
        )


class DynamicRangeForest(_DrfsQueryView):
    def __init__(
        self,
        net: RoadNetwork,
        ee: EdgeEvents,
        ctx: MomentContext,
        phi: np.ndarray,
        *,
        depth: int = 8,
        auto_seal: bool = True,
    ):
        self.net = net
        self.ctx = ctx
        # auto_seal=True: the geometric seal fires inside insert() (the
        # standalone streaming default — replay-deterministic because the
        # trigger is a pure function of event counts). auto_seal=False:
        # insert never seals; the owner schedules compact()/seal() off the
        # write path (the serve tier runs it between batches).
        self.auto_seal = bool(auto_seal)
        self.depth = 0
        E = net.n_edges
        # sealed event arrays (grouped by edge, time-sorted within edge)
        self.ptr = ee.ptr.copy()
        self.pos = ee.pos.copy()
        self.time = ee.time.copy()
        self.phi = phi.copy()
        self.lens = net.edge_len
        # per-depth CSR: levels[d] = (node_ptr [E*2^d+1], time_s [N], cum [N,4,K], ev_idx [N])
        self.levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        # streaming buffers
        self._pend_edge: List[np.ndarray] = []
        self._pend_pos: List[np.ndarray] = []
        self._pend_time: List[np.ndarray] = []
        self._pend_phi: List[np.ndarray] = []
        self._n_pending = 0
        self._pend_csr = None  # (pend_revision, csr) single-entry cache
        # mutation epochs: device engines re-pack when these move
        self.revision = 0  # sealed structure (seal / extend)
        self.pend_revision = 0  # pending buffers (insert / seal)
        # QueryStats work counters (TNKDE snapshots + diffs these per query):
        #   pending — (atom, pending-event-on-its-edge) pairs examined
        #   partial — (atom, boundary-leaf-event) pairs examined (exact mode)
        self.counters = {"pending": 0, "partial": 0}
        self._build_level(0)
        for _ in range(depth):
            self.extend()

    # ----------------------------------------------------------- structure
    @property
    def n_sealed(self) -> int:
        return int(self.pos.shape[0])

    @property
    def n_pending(self) -> int:
        return int(self._n_pending)

    @property
    def index_bytes(self) -> int:
        return sum(p.nbytes + t.nbytes + c.nbytes + i.nbytes for p, t, c, i in self.levels)

    def _node_of(self, edge: np.ndarray, pos: np.ndarray, d: int) -> np.ndarray:
        u = pos / self.lens[edge]
        return np.minimum((u * (1 << d)).astype(np.int64), (1 << d) - 1)

    def _build_level(self, d: int) -> None:
        E = self.net.n_edges
        counts = np.diff(self.ptr)
        edge_of = np.repeat(np.arange(E, dtype=np.int64), counts)
        node_local = self._node_of(edge_of, self.pos, d)
        node = edge_of * (1 << d) + node_local
        order = np.argsort(node, kind="stable")  # keeps time order inside node
        node_s = node[order]
        node_ptr = np.zeros(E * (1 << d) + 1, dtype=np.int64)
        np.add.at(node_ptr, node_s + 1, 1)
        np.cumsum(node_ptr, out=node_ptr)
        cum = segmented_cumsum(self.phi[order], node_ptr)
        self.levels.append((node_ptr, self.time[order], cum, order.astype(np.int64)))

    def extend(self) -> None:
        """Extension operation (Algorithm 4): add one depth level, O(N)."""
        self.depth += 1
        self._build_level(self.depth)
        self.revision += 1

    # ------------------------------------------------------------ streaming
    def insert(self, edge: np.ndarray, pos: np.ndarray, time: np.ndarray, phi: np.ndarray):
        """Streaming insertion (persistent/streaming mode, §5), O(batch).

        Arrival order does NOT matter for correctness: the pending CSR
        sorts by (edge, time) per materialization, and ``seal`` lexsorts
        the merged base arrays and re-sorts every dirty node's run — the
        sealed structure is a pure function of the event *set*. (Equal-time
        ties are summed over contiguous searchsorted ranges, so tie order
        cannot change a window sum either; the streaming property tests
        pin this with out-of-order interleavings against the SPS oracle.)

        With ``auto_seal`` (the default) a geometric ``seal`` merges the
        pending buffers when they exceed 25% of the sealed set; otherwise
        the buffers grow until the owner schedules a seal/compact.
        """
        self._pend_edge.append(np.asarray(edge, np.int64))
        self._pend_pos.append(np.asarray(pos, np.float64))
        self._pend_time.append(np.asarray(time, np.float64))
        self._pend_phi.append(np.asarray(phi))
        self._n_pending += len(pos)
        self.pend_revision += 1
        if self.auto_seal and self.needs_seal:
            self.seal()

    @property
    def needs_seal(self) -> bool:
        """The geometric compaction trigger: pending > 25% of sealed. A
        pure function of event counts, so replay re-fires it identically
        when ``auto_seal`` is on — and the serve tier polls it between
        batches when auto-seal is off (background compaction)."""
        return self._n_pending > max(self.n_sealed, 64) // 4

    def pending_csr(self):
        """Pending buffers as a per-edge CSR sorted by (edge, time).

        Returns (ptr [E+1], pos, time, phi) or None when nothing is pending.
        Shared by the host pending scan, the LS dominated path, the device
        engine's pending upload, and the work accounting — cached on
        ``pend_revision`` so the sort is paid once per insert, not per use.
        """
        if not self._n_pending:
            return None
        if self._pend_csr is not None and self._pend_csr[0] == self.pend_revision:
            return self._pend_csr[1]
        pe = np.concatenate(self._pend_edge)
        pp = np.concatenate(self._pend_pos)
        pt = np.concatenate(self._pend_time)
        pf = np.concatenate(self._pend_phi)
        ptr, order = group_by_edge_csr(self.net.n_edges, pe, pt)
        csr = (ptr, pp[order], pt[order], pf[order])
        self._pend_csr = (self.pend_revision, csr)
        return csr

    def seal(self) -> None:
        """Merge pending buffers into the sealed structure, incrementally.

        Only *dirty* edges (with pending events) are re-sorted and
        re-aggregated; every clean edge's per-level block is copied over
        verbatim (its node counts are unchanged — position bisection is
        data-independent), with its ``ev_idx`` rows shifted by the edge's
        CSR displacement. Cost: O(N) splice copies + O(n_dirty log n_dirty)
        sort + O(n_dirty · H · K) cumsum, vs O(N · H · K) for a full rebuild.
        """
        if not self._n_pending:
            return
        E = self.net.n_edges
        pe = np.concatenate(self._pend_edge)
        pp = np.concatenate(self._pend_pos)
        pt = np.concatenate(self._pend_time)
        pf = np.concatenate(self._pend_phi)
        po = np.lexsort((pt, pe))
        pe, pp, pt, pf = pe[po], pp[po], pt[po], pf[po]

        counts_old = np.diff(self.ptr)
        pend_counts = np.bincount(pe, minlength=E).astype(np.int64)
        dirty = pend_counts > 0  # [E]
        counts_new = counts_old + pend_counts
        new_ptr = np.zeros(E + 1, dtype=np.int64)
        np.cumsum(counts_new, out=new_ptr[1:])
        N_old, N_new = self.n_sealed, int(new_ptr[-1])
        edge_old = np.repeat(np.arange(E, dtype=np.int64), counts_old)
        shift = new_ptr[:-1] - self.ptr[:-1]  # [E] per-edge CSR displacement
        dirty_ev = dirty[edge_old] if N_old else np.zeros(0, bool)

        # ---- merge the sealed base arrays (dirty events + pending only) ----
        de = np.concatenate([edge_old[dirty_ev], pe])
        dp = np.concatenate([self.pos[dirty_ev], pp])
        dt = np.concatenate([self.time[dirty_ev], pt])
        dphi = np.concatenate([self.phi[dirty_ev], pf]) if self.phi.size else pf
        dm = np.lexsort((dt, de))  # stable: old-before-pending on time ties

        K_tail = pf.shape[1:]
        new_pos = np.empty(N_new)
        new_time = np.empty(N_new)
        # promote like np.concatenate would — a float32 insert must not
        # silently downcast the sealed float64 moment history
        new_phi = np.empty((N_new,) + K_tail, dtype=np.result_type(self.phi.dtype, pf.dtype))
        old_idx = np.arange(N_old, dtype=np.int64)
        clean_src = old_idx[~dirty_ev]
        clean_dst = clean_src + shift[edge_old[~dirty_ev]]
        new_pos[clean_dst] = self.pos[clean_src]
        new_time[clean_dst] = self.time[clean_src]
        if self.phi.size:
            new_phi[clean_dst] = self.phi[clean_src]
        d_edges = np.nonzero(dirty)[0]
        dirty_dst = ragged_arange(new_ptr[d_edges], counts_new[d_edges])
        new_pos[dirty_dst] = dp[dm]
        new_time[dirty_dst] = dt[dm]
        new_phi[dirty_dst] = dphi[dm]
        # old sealed index -> new sealed index (for per-level ev_idx remap)
        old_to_new = np.empty(N_old, np.int64)
        old_to_new[clean_src] = clean_dst
        src_tag = np.concatenate([old_idx[dirty_ev], np.full(len(pe), -1, np.int64)])
        tag_s = src_tag[dm]
        was_old = tag_s >= 0
        old_to_new[tag_s[was_old]] = dirty_dst[was_old]

        new_levels = self._splice_levels(
            new_ptr, new_pos, new_time, new_phi, dirty, old_to_new
        )

        self.ptr, self.pos, self.time, self.phi = new_ptr, new_pos, new_time, new_phi
        self.levels = new_levels
        self._pend_edge, self._pend_pos, self._pend_time, self._pend_phi = [], [], [], []
        self._n_pending = 0
        self._pend_csr = None
        self.revision += 1
        self.pend_revision += 1

    def _splice_levels(self, new_ptr, new_pos, new_time, new_phi, dirty, old_to_new):
        """Rebuild every level's CSR over new base arrays, incrementally.

        Shared by :meth:`seal` and :meth:`evict_before`: clean edges (those
        whose event set did not change) have their per-level blocks copied
        verbatim with a uniform shift and their ``ev_idx`` rows remapped
        through ``old_to_new``; dirty edges are node-grouped, time-sorted
        within node (the new base arrays are already (edge, time)-sorted,
        and the stable node argsort preserves that) and freshly cumsum'd.
        Must be called BEFORE the base arrays are rebound — it reads the
        old structure from ``self``. Allocates fresh arrays (MVCC).
        """
        E = self.net.n_edges
        N_old = self.n_sealed
        N_new = int(new_ptr[-1])
        counts_new = np.diff(new_ptr)
        edge_old = np.repeat(np.arange(E, dtype=np.int64), np.diff(self.ptr))
        edge_new = np.repeat(np.arange(E, dtype=np.int64), counts_new)
        sel = np.nonzero(dirty[edge_new])[0]  # dirty events, new-array order
        new_levels = []
        eid_range = np.arange(E, dtype=np.int64)
        for d, (nptr, tms, cum, eidx) in enumerate(self.levels):
            nb = 1 << d
            cnt_nodes_old = np.diff(nptr)
            nl = self._node_of(edge_new[sel], new_pos[sel], d)
            node_d = edge_new[sel] * nb + nl
            order_d = np.argsort(node_d, kind="stable")
            node_counts_dirty = np.bincount(node_d, minlength=E * nb).astype(np.int64)
            cnt_nodes_new = np.where(np.repeat(dirty, nb), node_counts_dirty, cnt_nodes_old)
            nptr_new = np.zeros(E * nb + 1, np.int64)
            np.cumsum(cnt_nodes_new, out=nptr_new[1:])
            tms_new = np.empty(N_new)
            cum_new = np.empty((N_new,) + cum.shape[1:], dtype=cum.dtype)
            eidx_new = np.empty(N_new, np.int64)
            # clean edges: the whole per-edge block shifts uniformly
            if N_old:
                edge_of_slot = edge_old[eidx]
                lvl_shift = nptr_new[eid_range * nb] - nptr[eid_range * nb]
                clean_slot = np.nonzero(~dirty[edge_of_slot])[0]
                dst_clean = clean_slot + lvl_shift[edge_of_slot[clean_slot]]
                tms_new[dst_clean] = tms[clean_slot]
                cum_new[dst_clean] = cum[clean_slot]
                eidx_new[dst_clean] = old_to_new[eidx[clean_slot]]
            # dirty edges: node-grouped, time-sorted within node, fresh cumsum
            ev_sorted = sel[order_d]
            dirty_nodes = np.nonzero(np.repeat(dirty, nb))[0]
            ddst = ragged_arange(nptr_new[dirty_nodes], cnt_nodes_new[dirty_nodes])
            tms_new[ddst] = new_time[ev_sorted]
            eidx_new[ddst] = ev_sorted
            seg_ptr = np.concatenate([[0], np.cumsum(cnt_nodes_new[dirty_nodes])]).astype(np.int64)
            cum_new[ddst] = segmented_cumsum(new_phi[ev_sorted], seg_ptr)
            new_levels.append((nptr_new, tms_new, cum_new, eidx_new))
        return new_levels

    def evict_before(self, cutoff: float) -> Optional[np.ndarray]:
        """Expire every event with ``time < cutoff`` (sliding time horizon).

        Extends DRFS from insert-only to insert+expire: an infinite stream
        with a horizon runs in bounded memory. Pending buffers are filtered
        by value; sealed events are dropped and only the *dirty* edges
        (those that lost events) have their per-level runs rebuilt — clean
        edges splice through :meth:`_splice_levels` exactly like an
        incremental seal. Because sealed runs are time-sorted per edge,
        eviction removes a per-edge prefix regardless of arrival order.

        Allocates fresh arrays and rebinds (MVCC) — pinned snapshots keep
        answering over the pre-eviction state. Bumps ``revision`` when
        sealed state changed and ``pend_revision`` when pending changed, so
        device packs and plan caches invalidate exactly where needed.

        Returns the per-edge removed counts (int64 [E], sealed + pending),
        or ``None`` when nothing was evicted. NOT a pure function of event
        counts — callers must WAL-log the eviction for deterministic replay.
        """
        cutoff = float(cutoff)
        E = self.net.n_edges
        removed = np.zeros(E, np.int64)
        # ---- pending buffers: filter by value --------------------------------
        if self._n_pending:
            pe = np.concatenate(self._pend_edge)
            pp = np.concatenate(self._pend_pos)
            pt = np.concatenate(self._pend_time)
            pf = np.concatenate(self._pend_phi)
            keep_p = pt >= cutoff
            n_drop = int((~keep_p).sum())
            if n_drop:
                removed += np.bincount(pe[~keep_p], minlength=E).astype(np.int64)
                if keep_p.any():
                    self._pend_edge = [pe[keep_p]]
                    self._pend_pos = [pp[keep_p]]
                    self._pend_time = [pt[keep_p]]
                    self._pend_phi = [pf[keep_p]]
                else:
                    self._pend_edge, self._pend_pos = [], []
                    self._pend_time, self._pend_phi = [], []
                self._n_pending -= n_drop
                self._pend_csr = None
                self.pend_revision += 1
        # ---- sealed arrays: per-edge prefix drop + dirty-edge splice ---------
        keep = self.time >= cutoff
        if not keep.all():
            counts_old = np.diff(self.ptr)
            edge_old = np.repeat(np.arange(E, dtype=np.int64), counts_old)
            drop_counts = np.bincount(edge_old[~keep], minlength=E).astype(np.int64)
            removed += drop_counts
            dirty = drop_counts > 0
            counts_new = counts_old - drop_counts
            new_ptr = np.zeros(E + 1, np.int64)
            np.cumsum(counts_new, out=new_ptr[1:])
            new_pos = self.pos[keep]
            new_time = self.time[keep]
            new_phi = self.phi[keep]
            N_old = self.n_sealed
            old_to_new = np.full(N_old, -1, np.int64)
            old_to_new[keep] = np.arange(int(keep.sum()), dtype=np.int64)
            new_levels = self._splice_levels(
                new_ptr, new_pos, new_time, new_phi, dirty, old_to_new
            )
            self.ptr, self.pos, self.time, self.phi = new_ptr, new_pos, new_time, new_phi
            self.levels = new_levels
            self.revision += 1
        return removed if removed.any() else None

    # ----------------------------------------------------- durability (WAL)
    def state_tree(self) -> dict:
        """Flat host-array capture of the **sealed** structure — the payload
        of a ``TNKDE.checkpoint`` (DESIGN.md §8). Callers seal first: the
        pending buffers are ephemeral by contract (their inserts are in the
        WAL, so recovery replays them); refusing to snapshot them keeps the
        checkpoint format one sealed structure, not two.

        Arrays are returned by reference — safe to persist asynchronously,
        because every mutation rebinds fresh arrays (MVCC) instead of
        writing in place.
        """
        if self._n_pending:
            raise ValueError("state_tree() requires a sealed forest (seal() first)")
        tree = {"ptr": self.ptr, "pos": self.pos, "time": self.time, "phi": self.phi}
        for d, (node_ptr, time_s, cum, ev_idx) in enumerate(self.levels):
            tree[f"lvl{d}_ptr"] = node_ptr
            tree[f"lvl{d}_time"] = time_s
            tree[f"lvl{d}_cum"] = cum
            tree[f"lvl{d}_idx"] = ev_idx
        return tree

    def load_state(
        self, tree: dict, *, depth: int, revision: int, pend_revision: int
    ) -> None:
        """Rebind the sealed structure from a :meth:`state_tree` capture.

        The inverse of checkpointing: after this, the forest is exactly the
        captured sealed state at the captured epoch — replaying the WAL
        suffix then reproduces the pre-crash state bit-for-bit (mutation is
        deterministic in the operation sequence).
        """
        self.depth = int(depth)
        self.ptr = tree["ptr"]
        self.pos = tree["pos"]
        self.time = tree["time"]
        self.phi = tree["phi"]
        self.levels = [
            (
                tree[f"lvl{d}_ptr"],
                tree[f"lvl{d}_time"],
                tree[f"lvl{d}_cum"],
                tree[f"lvl{d}_idx"],
            )
            for d in range(self.depth + 1)
        ]
        self._pend_edge, self._pend_pos, self._pend_time, self._pend_phi = [], [], [], []
        self._n_pending = 0
        self._pend_csr = None
        self.revision = int(revision)
        self.pend_revision = int(pend_revision)

    # ----------------------------------------------------------------- MVCC
    @property
    def epoch(self) -> Tuple[int, int]:
        """(revision, pend_revision) — the identity of the current state."""
        return (self.revision, self.pend_revision)

    def snapshot(self) -> DrfsSnapshot:
        """Pin the current state as an immutable :class:`DrfsSnapshot`.

        O(levels) — every captured array is shared by reference (mutations
        rebind, never overwrite), so taking a snapshot per query is free.
        """
        return DrfsSnapshot(self)


def _pos_mask(atoms: AtomSet, rep_atom: np.ndarray, p: np.ndarray) -> np.ndarray:
    hi_ok = p <= atoms.pos_hi[rep_atom]
    lo1 = atoms.pos_lo1[rep_atom]
    lo1_ok = np.where(atoms.lo1_right[rep_atom], p > lo1, p >= lo1)
    lo2_ok = p >= atoms.pos_lo2[rep_atom]
    return hi_ok & lo1_ok & lo2_ok
