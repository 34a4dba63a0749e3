"""TN-KDE front end (paper Algorithm 1 + Algorithm 5), PyTorch port.

Ties the pieces together: lixelization, SPS shortest-path sharing, candidate
pruning, Lixel Sharing classification, atom planning, and the solutions this
package serves so far:

  solution='sps'   index-free direct evaluation            (§3.2 baseline)
  solution='rfs'   range forest (static, exact)            (§4)

``query(ts)`` answers a *batch* of online time windows (the paper's multiple
temporal KDE scenario, §8.2): build once, query many.

``engine`` selects the flush backend for the forest solution:

  engine='torch'  window-batched device engine (rfs.FlatForestEngine): all W
                  windows per flush, device-resident [L, W] float64 heatmap,
                  one transfer per query. Runs on ``device`` (default
                  ``'cuda'``; with no card the constructor raises — pass
                  ``device='cpu'`` for the plain-torch path on the host).
  engine='numpy'  the host reference path (one eval_atoms pass per window)
  engine='auto'   'torch' for rfs, 'numpy' for sps

``executor`` picks the device executor over the packed query plan:
'packed' (gather-lean plain torch, what 'auto' resolves to) or 'fused' (ONE
hand-written CUDA ``fused_walk`` launch per atom pack, DESIGN.md §12). Every
query reuses the plan cached for its (epoch, LS) pair — warm queries skip
planning entirely — and window-side tables cached by the ts tuple
(DESIGN.md §7).

What the reference package (``repro.core.tnkde``) serves and this one does
not yet raises ``NotImplementedError`` naming its ROADMAP.md queue item —
never a silent different path.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional, Sequence

import numpy as np

from .aggregation import build_event_moments
from .events import Events, group_events_by_edge
from .kernels_math import get_kernel
from .lixel_sharing import dominated_sweep
from .network import RoadNetwork, build_lixels
from .plan import build_edge_geometry
from .query_plan import PlanCache, build_host_plan
from .rfs import RangeForest
from .shortest_path import adjacency_csr, bounded_dijkstra
from .sps import sps_eval_edge

__all__ = ["TNKDE", "PendingQuery", "QueryStats"]

# arguments and methods of the reference that later slices of the port bring
_LATER = {
    "drfs": "solution='drfs' (streaming DRFS): ROADMAP.md Queue A4",
    "ada": "solution='ada' (per-window linear index): ROADMAP.md Queue A3/A4",
    "table_codec": "table_codec other than 'auto'/'f64' (TableCodec): ROADMAP.md Queue A3",
    "mesh": "mesh= (sharded forest): ROADMAP.md Queue A8",
    "pallas": "executor='pallas' (kernel-per-level tier): ROADMAP.md Queue A5",
    "search": "executor='search' (legacy executor): ROADMAP.md Queue A5",
    "cascade": "executor='cascade' (legacy executor): ROADMAP.md Queue A5",
    "horizon_s": "horizon_s= (sliding time horizon): ROADMAP.md Queue A4",
}
_LATER_METHODS = {
    "insert": "A4", "seal": "A4", "extend": "A4", "compact": "A4", "snapshot": "A4",
    "degrade": "A5", "attach_wal": "A6", "checkpoint": "A6", "restore": "A6",
}


@dataclasses.dataclass
class QueryStats:
    build_seconds: float = 0.0
    query_seconds: float = 0.0
    sp_seconds: float = 0.0
    n_atoms: int = 0
    n_pairs_dominated: int = 0
    n_pairs_out: int = 0
    n_pairs_normal: int = 0
    index_bytes: int = 0
    # device-engine op accounting (the packed-plan hoist invariants,
    # DESIGN.md §7): time-boundary binary-search problems solved, and
    # prefix/node moment rows gathered. Searches scale with the NODE count
    # of the window tables (zero on a warm plan hit), never with atoms;
    # the walk gathers one paired node row per (level, atom).
    n_rank_searches: int = 0
    n_moment_gathers: int = 0
    # analytic memory-traffic model of the gathers above: gather count ×
    # gathered-row bytes, same units for every engine/executor and the same
    # formulas as the reference package (hardware-independent).
    bytes_moved: int = 0
    # device bytes the engine holds (index tables + cached packed plans)
    bytes_per_shard: int = 0


class TNKDE:
    def __init__(
        self,
        net: RoadNetwork,
        events: Events,
        *,
        g: float = 10.0,
        b_s: float = 1000.0,
        b_t: float = 86400.0,
        spatial_kernel: str = "triangular",
        temporal_kernel: str = "triangular",
        solution: str = "rfs",
        engine: str = "auto",
        executor: str = "auto",
        table_codec: str = "auto",
        mesh=None,
        lixel_sharing: bool = False,
        cascade: bool = True,
        horizon_s: Optional[float] = None,
        edge_block: int = 128,
        atom_flush: int = 400_000,
        device="cuda",
    ):
        if solution in ("drfs", "ada"):
            raise NotImplementedError(_LATER[solution])
        if solution not in ("sps", "rfs"):
            raise ValueError(f"unknown solution {solution!r}")
        if engine not in ("auto", "numpy", "torch"):
            raise ValueError(f"unknown engine {engine!r} (this package: 'auto', 'numpy', 'torch')")
        if engine == "torch" and solution != "rfs":
            raise ValueError("engine='torch' accelerates the forest flush (solution='rfs')")
        if executor in ("pallas", "search", "cascade"):
            raise NotImplementedError(_LATER[executor])
        if executor not in ("auto", "packed", "fused"):
            raise ValueError(f"unknown executor {executor!r}")
        if table_codec in ("f32", "bf16"):
            raise NotImplementedError(_LATER["table_codec"])
        if table_codec not in ("auto", "f64"):
            raise ValueError(f"unknown table_codec {table_codec!r}")
        if mesh is not None:
            raise NotImplementedError(_LATER["mesh"])
        if horizon_s is not None:
            raise NotImplementedError(_LATER["horizon_s"])
        if lixel_sharing and solution == "sps":
            raise ValueError("lixel sharing needs an aggregation index (rfs)")
        t0 = _time.perf_counter()
        self.net = net
        self.g = g
        self.solution = solution
        self.ls = lixel_sharing
        self.cascade = cascade
        self.edge_block = edge_block
        self.atom_flush = atom_flush
        self.device = device
        self.lix = build_lixels(net, g)
        self.ee = group_events_by_edge(net, events)
        ks = get_kernel(spatial_kernel)
        kt = get_kernel(temporal_kernel)
        self.ctx, phi = build_event_moments(net, self.ee, ks, kt, b_s, b_t)
        self.index = None
        if solution == "rfs":
            self.index = RangeForest(net, self.ee, self.ctx, phi, build_bridges=cascade)
        self._engine_req = engine
        self._executor_req = executor
        self._build_engine()
        # cumulative consumption cursors over the engine work counters
        # (see _consume_counters)
        self._counter_cursor: dict = {}
        self._adj = adjacency_csr(net)
        # per-edge event extremes for window-independent LS classification
        E = net.n_edges
        self.ev_min_pos = np.full(E, np.inf)
        self.ev_max_pos = np.full(E, -np.inf)
        counts = np.diff(self.ee.ptr)
        eo = np.repeat(np.arange(E), counts)
        if self.ee.n:
            np.minimum.at(self.ev_min_pos, eo, self.ee.pos)
            np.maximum.at(self.ev_max_pos, eo, self.ee.pos)
        self.stats = QueryStats(build_seconds=_time.perf_counter() - t0)
        if self.index is not None:
            self.stats.index_bytes = self.index.index_bytes

    def _build_engine(self) -> None:
        """Bind the flush engine + plan cache for the requested
        ``(engine, executor)``. A device engine that cannot be built raises:
        there is no fallback to the host path."""
        self.engine = "numpy"
        self._fe = None
        if self.solution == "rfs" and self._engine_req != "numpy":
            from .rfs import FlatForestEngine

            self._fe = FlatForestEngine(
                self.index, executor=self._executor_req, device=self.device
            )
            self.engine = "torch"
        self._plan_cache = PlanCache(2)

    # ------------------------------------------------------------------ API
    @property
    def n_lixels(self) -> int:
        return self.lix.n_lixels

    @property
    def engine_desc(self) -> str:
        """Human-readable backend/executor that actually answers queries,
        e.g. ``'torch/fused'``, ``'torch/packed'`` or ``'numpy'``."""
        if self._fe is None:
            return "numpy"
        return f"{self.engine}/{self._fe.executor}"

    @property
    def epoch(self):
        """(revision, pend_revision) of the index — (0, 0): static indexes."""
        return (0, 0)

    def edge_geometries(self):
        """Yield the window-independent EdgeGeometry of every query edge with
        at least one lixel — the planning loop (SPS rows are computed per
        edge block)."""
        net, lix, ee, ctx = self.net, self.lix, self.ee, self.ctx
        E = net.n_edges
        radius = ctx.b_s + float(net.edge_len.max()) + 1.0
        for blk_lo in range(0, E, self.edge_block):
            blk = np.arange(blk_lo, min(blk_lo + self.edge_block, E))
            verts = np.unique(
                np.concatenate([net.edge_src[blk], net.edge_dst[blk]])
            )
            t_sp = _time.perf_counter()
            rows = bounded_dijkstra(net, verts, radius, adj=self._adj)
            self.stats.sp_seconds += _time.perf_counter() - t_sp
            vmap = {int(v): i for i, v in enumerate(verts)}
            for a in blk:
                ra = rows[vmap[int(net.edge_src[a])]]
                rb = rows[vmap[int(net.edge_dst[a])]]
                geom = build_edge_geometry(
                    net, lix, ee, int(a), ctx.b_s, np.stack([ra, rb])
                )
                if geom.x.shape[0]:
                    yield geom

    def _host_plan(self):
        """The window-independent packed query plan for the current epoch.

        One planning walk (Dijkstra + geometry + atoms + LS classification)
        per (epoch, LS-mode), LRU-cached — a warm query skips planning
        entirely (DESIGN.md §7).
        """
        key = (self.epoch, self.ls)
        plan = self._plan_cache.get(key)
        if plan is None:
            cap = (
                self.atom_flush
                if self._fe is None
                # device blocks are capped so the walk state (O(W · M) per
                # flush) stays within device memory
                else min(self.atom_flush, 200_000)
            )
            plan = build_host_plan(self, key, flush_cap=cap, ls=self.ls)
            self._plan_cache.put(key, plan)
        return plan

    def dispatch(self, ts: Sequence[float]) -> "PendingQuery":
        """Begin a query asynchronously; returns a :class:`PendingQuery`.

        The host-side work — planning, window tables, atom packs — runs now,
        and the device flush is *enqueued* (CUDA launches are asynchronous),
        but the device→host transfer and the Lixel-Sharing dominated sweep
        are deferred to :meth:`PendingQuery.result`. Host-only paths
        (numpy/sps) evaluate eagerly here; ``result()`` then returns the
        stored array.
        """
        ts = list(map(float, ts))
        t0 = _time.perf_counter()
        W = len(ts)
        L = self.lix.n_lixels
        F = np.zeros((W, L))
        if W == 0:
            return PendingQuery(self, ts, F)
        ee, ctx = self.ee, self.ctx
        if self.solution == "sps":
            for geom in self.edge_geometries():
                sl = slice(geom.lix_base, geom.lix_base + geom.x.shape[0])
                for w, t in enumerate(ts):
                    F[w, sl] += sps_eval_edge(geom, ee, ctx, t)
            self.stats.query_seconds += _time.perf_counter() - t0
            return PendingQuery(self, ts, F)
        # ---- packed plan: atoms + dominated work, cached per epoch ---------
        plan = self._host_plan()
        self.stats.n_atoms += plan.n_atoms
        self.stats.n_pairs_dominated += plan.pairs[0]
        self.stats.n_pairs_out += plan.pairs[1]
        self.stats.n_pairs_normal += plan.pairs[2]
        heat = None
        if self._fe is not None:
            # all W windows ride one device pass per block; the heatmap stays
            # device-resident (and the flush merely *enqueued*) until result()
            wb = self._fe.window_batch(ctx, ts)
            heat = self._fe.new_heatmap(L, W)
            heat = self._fe.flush_plan(heat, plan, wb, tuple(ts))
        else:
            for atoms in plan.blocks:
                for w, t in enumerate(ts):
                    vals = self.index.eval_atoms(atoms, t, cascade=self.cascade)
                    np.add.at(F[w], atoms.lixel, vals)
        self.stats.query_seconds += _time.perf_counter() - t0
        return PendingQuery(self, ts, F, heat=heat, plan=plan)

    def _consume_counters(self) -> None:
        """Fold the engine work counters into ``stats`` via cumulative
        cursors. Cursor-based (not bracketing snapshots) so overlapping
        in-flight dispatches never double-count — each unit of work is
        consumed by exactly one ``result()``."""
        if self._fe is None:
            return
        eng = self._fe.counters
        for name, stat in (("rank_searches", "n_rank_searches"),
                           ("moment_gathers", "n_moment_gathers"),
                           ("bytes_moved", "bytes_moved")):
            cur = int(eng[name])
            prev = self._counter_cursor.get(name, 0)
            setattr(self.stats, stat, getattr(self.stats, stat) + cur - prev)
            self._counter_cursor[name] = cur
        self.stats.bytes_per_shard = self._fe.bytes_per_shard

    def query(self, ts: Sequence[float]) -> np.ndarray:
        """KDE values for every lixel, for each window center in ts: [W, L]
        float64. Equivalent to ``dispatch(ts).result()``."""
        return self.dispatch(ts).result()


def _later_method(name, item):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"TNKDE.{name}() is not part of the PyTorch port yet: ROADMAP.md Queue {item}"
        )

    method.__name__ = name
    method.__doc__ = f"Served by the reference package only so far (ROADMAP.md Queue {item})."
    return method


for _name, _item in _LATER_METHODS.items():
    setattr(TNKDE, _name, _later_method(_name, _item))


class PendingQuery:
    """Handle to an in-flight :meth:`TNKDE.dispatch` (DESIGN.md §10).

    Holds the device-resident [L, W] heatmap whose flush is enqueued but not
    necessarily finished; :meth:`result` blocks on the device (the one
    device→host transfer), applies the host-side Lixel-Sharing dominated
    sweep, folds the work counters into ``TNKDE.stats`` and returns the
    [W, L] array. Idempotent — repeated calls return the same materialized
    array. Host-path dispatches arrive here already evaluated.
    """

    __slots__ = ("_model", "_ts", "_F", "_heat", "_plan", "_done")

    def __init__(self, model, ts, F, *, heat=None, plan=None):
        self._model = model
        self._ts = ts
        self._F = F
        self._heat = heat
        self._plan = plan
        self._done = plan is None  # W==0 / sps dispatches need no finalize

    @property
    def ts(self) -> List[float]:
        return list(self._ts)

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> np.ndarray:
        if self._done:
            return self._F
        model = self._model
        t0 = _time.perf_counter()
        if self._heat is not None:
            # the blocking device->host transfer (everything enqueued by
            # dispatch completes before the bytes land)
            self._F += model._fe.to_numpy(self._heat)
            self._heat = None
        # ---- Lixel Sharing: dominated edges, batched across the network ----
        if self._plan.dominated:
            dominated_sweep(self._F, model.index, model.ctx, self._plan.dominated,
                            self._ts)
        model._consume_counters()
        model.stats.query_seconds += _time.perf_counter() - t0
        self._done = True
        self._plan = None  # drop the plan pin
        return self._F
