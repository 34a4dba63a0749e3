"""TN-KDE front end (paper Algorithm 1 + Algorithm 5), PyTorch port.

Ties the pieces together: lixelization, SPS shortest-path sharing, candidate
pruning, Lixel Sharing classification, atom planning, and the solutions this
package serves so far:

  solution='sps'   index-free direct evaluation              (§3.2 baseline)
  solution='ada'   aggregate distance augmentation (SOTA)    (§3.2, per-window index)
  solution='rfs'   range forest (static, exact)              (§4)
  solution='drfs'  dynamic range forest (streaming, ~exact)  (§5)

``query(ts)`` answers a *batch* of online time windows (the paper's multiple
temporal KDE scenario, §8.2): build once, query many. The DRFS index also
takes streaming inserts (``insert``), seals them into the tree (``seal``,
``compact``), expires events past a sliding horizon (``horizon_s``), grows
a level (``extend``) and answers against pinned snapshots
(``query(ts, at=snapshot())``, MVCC).

``engine`` selects the flush backend for the forest solutions:

  engine='torch'  window-batched device engine, all W windows per flush,
                  device-resident [L, W] float64 heatmap, one transfer per
                  query: rfs -> rfs.FlatForestEngine, drfs ->
                  rfs.FlatDynamicEngine. Runs on ``device`` (default
                  ``'cuda'``; with no card the constructor raises — pass
                  ``device='cpu'`` for the plain-torch path on the host).
  engine='numpy'  the host reference path (one eval_atoms pass per window)
  engine='auto'   'torch' for rfs/drfs, 'numpy' for sps/ada. A device engine
                  that cannot be built raises; there is no fallback.

``executor`` picks the device executor over the packed query plan:
'packed' (plain torch, what 'auto' resolves to), 'fused' (ONE
hand-written CUDA launch per atom block: ``fused_walk`` for rfs and DRFS
exact mode, ``fused_leaf`` for DRFS quantized mode; DESIGN.md §12),
'kernel' (the per-bucket-search tier, ONE hand-written CUDA launch per atom
block: ``tree_query`` over the time-major flat forest for rfs,
``dyn_leaf_query_flat`` for DRFS quantized mode, ``dyn_node_walk_flat`` for
DRFS exact mode), or, rfs only, 'search' / 'cascade' (the reference's
per-bucket binary searches and fractional-cascading walk over the
time-major forest, plain torch; ``cascade=False`` builds no bridges, and
'cascade' then runs 'search', as the reference does). 'kernel' is this
package's name for the reference's ``executor='pallas'``, which raises
``ValueError`` here. Every flush ends in the fixed-order scatter
(``ops.segment_add``), so a window's answer does not depend on the flush it
rode in. Every query reuses the plan cached for its (epoch, LS) pair — warm
queries skip planning entirely — and window-side tables cached by the ts
tuple (DESIGN.md §7).

``mesh`` (a ``distributed.ShardMesh``) shards the forest index across the
mesh's ``shard_axes`` (DESIGN.md §3): the packed executor runs per shard
slab and the per-shard heatmap deltas are summed in shard order, so sharded
== single-host to summation-order noise, and ``QueryStats.bytes_per_shard``
reports the heaviest shard. rfs/drfs, the packed executor and f64 tables
only; ``engine_desc`` reads ``torch/packed@shards=N``.

Durability (DESIGN.md §8): ``attach_wal`` logs every mutation of a DRFS
index to a :class:`wal.WriteAheadLog` before it applies, ``checkpoint``
persists the sealed index through the atomic-COMMIT layout of
``repro_torch.ckpt``, and ``restore`` rebinds the latest committed
checkpoint and replays the WAL suffix. The WAL bytes, the checkpoint layout
and the config fingerprint are the reference package's, so either package
recovers the other's state. ``degrade`` trips the executor ladder
``torch/fused`` (or ``torch/kernel``) → ``torch/packed`` → ``numpy``; on the
card it stops at ``torch/packed``.

``table_codec`` picks the storage dtype of the device window tables
(``torch_engine.TableCodec``): 'auto'/'f64' (exact tier), 'f32' or 'bf16'
(float32 / bfloat16 node values; DRFS quantized mode stores float32
delta-encoded leaf prefixes under both). The tables are validated at build
and fall back to f64 in place when they cannot hold the index
(``table_codec_used.fallback_reason``); the arithmetic stays float64. RFS
``executor='kernel'`` reads the raw f64 forest, so the codec does not reach
it; ``engine='numpy'`` ignores it.

Everything the reference's ``TNKDE`` serves, this one serves.
"""
from __future__ import annotations

import dataclasses
import itertools
import time as _time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .ada import AggregateDistanceIndex
from .aggregation import build_event_moments
from .drfs import DynamicRangeForest
from .events import (
    EdgeEvents,
    EventCountsView,
    Events,
    group_events_by_edge,
    ragged_arange,
    validate_events,
)
from .kernels_math import get_kernel
from .lixel_sharing import dominated_sweep
from .network import RoadNetwork, build_lixels
from .plan import build_edge_geometry
from .query_plan import PlanCache, build_host_plan
from .rfs import RangeForest
from .shortest_path import adjacency_csr, bounded_dijkstra
from .sps import sps_eval_edge
from . import wal as _wal
from .. import obs

__all__ = ["TNKDE", "PendingQuery", "QueryStats"]

_query_ids = itertools.count(1)  # PendingQuery ids in the spans, per process


@dataclasses.dataclass
class QueryStats:
    build_seconds: float = 0.0
    n_atoms: int = 0
    n_pairs_dominated: int = 0
    n_pairs_out: int = 0
    n_pairs_normal: int = 0
    index_bytes: int = 0
    # DRFS streaming work that the index answers *outside* the tree walk —
    # (atom, event) pairs examined by the pending-buffer scans and by the
    # exact-mode partial-leaf scans (the O(n) fallbacks the seal amortizes).
    n_pending_scanned: int = 0
    n_partial_scanned: int = 0
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
    # device bytes each participating shard holds (index tables + cached
    # packed plans): the whole engine on one device, the heaviest slab of a
    # sharded engine — the measured form of the 1/shards memory scaling
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
        shard_axes: Sequence[str] = ("data",),
        lixel_sharing: bool = False,
        cascade: bool = True,
        drfs_depth: int = 8,
        drfs_h0: Optional[int] = None,
        drfs_exact_leaf: bool = False,
        auto_seal: bool = True,
        horizon_s: Optional[float] = None,
        edge_block: int = 128,
        atom_flush: int = 400_000,
        device="cuda",
    ):
        if solution not in ("sps", "ada", "rfs", "drfs"):
            raise ValueError(f"unknown solution {solution!r}")
        if engine not in ("auto", "numpy", "torch"):
            raise ValueError(f"unknown engine {engine!r} (this package: 'auto', 'numpy', 'torch')")
        if engine == "torch" and solution not in ("rfs", "drfs"):
            raise ValueError("engine='torch' accelerates the forest flush (solution='rfs'/'drfs')")
        if solution == "drfs" and executor in ("search", "cascade"):
            raise ValueError("search/cascade executors are rfs-only")
        if executor == "pallas":
            raise ValueError("executor='pallas' is the reference package's name: this "
                             "package serves that tier as executor='kernel'")
        if executor not in ("auto", "packed", "fused", "kernel", "search", "cascade"):
            raise ValueError(f"unknown executor {executor!r}")
        if table_codec not in ("auto", "f64", "f32", "bf16"):
            raise ValueError(f"unknown table_codec {table_codec!r}")
        if mesh is not None:
            if solution not in ("rfs", "drfs"):
                raise ValueError("mesh= shards the forest indexes (rfs/drfs)")
            if engine == "numpy" or executor in ("search", "cascade", "fused", "kernel"):
                raise ValueError(
                    "the sharded path runs the packed torch executor "
                    "(engine='torch'/'auto', executor='packed'/'auto')"
                )
            if table_codec not in ("auto", "f64"):
                raise ValueError("the sharded path keeps f64 slabs (table_codec='auto'/'f64')")
            if {d.type for d in mesh.devices} != {torch.device(device).type}:
                raise ValueError(f"mesh devices {[str(d) for d in mesh.devices]} are not of "
                                 f"device={str(device)!r}, where degrade() rebuilds the model")
        if lixel_sharing and solution == "sps":
            raise ValueError("lixel sharing needs an aggregation index (ada/rfs/drfs)")
        if horizon_s is not None:
            if solution != "drfs":
                raise ValueError("horizon_s= (sliding time horizon) requires solution='drfs'")
            horizon_s = float(horizon_s)
            if not horizon_s > 0.0:
                raise ValueError(f"horizon_s must be positive, got {horizon_s!r}")
        if not auto_seal and solution != "drfs":
            raise ValueError("auto_seal=False requires solution='drfs'")
        t0 = _time.perf_counter()
        self.net = net
        self.g = g
        self.solution = solution
        self.ls = lixel_sharing
        self.cascade = cascade
        self.drfs_h0 = drfs_h0
        self.drfs_exact_leaf = drfs_exact_leaf
        self.auto_seal = bool(auto_seal)
        self.horizon_s = horizon_s
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
        elif solution == "drfs":
            self.index = DynamicRangeForest(
                net, self.ee, self.ctx, phi, depth=drfs_depth, auto_seal=auto_seal
            )
        elif solution == "ada":
            self.index = AggregateDistanceIndex(net, self.ee, self.ctx)
        self.mesh = mesh
        self.shard_axes = tuple(shard_axes)
        self._engine_req = engine
        self._executor_req = executor
        self.table_codec = table_codec
        self._build_engine()
        # cumulative consumption cursors over the index/engine work counters
        # (see _consume_counters)
        self._counter_cursor: dict = {}
        # ---- durability: WAL hookup + config identity (DESIGN.md §8) -------
        self._wal = None  # attach_wal(); logged-before-mutation when set
        self._replaying = False  # replay must not re-log its own records
        self._ckpt_step = 0
        self._ckpt_thread = None  # in-flight blocking=False checkpoint
        # the reference package's keys and values: a checkpoint taken by
        # either package passes the other's check
        self._fingerprint = dict(
            solution=solution,
            g=float(g),
            b_s=float(b_s),
            b_t=float(b_t),
            spatial_kernel=spatial_kernel,
            temporal_kernel=temporal_kernel,
            drfs_depth=int(drfs_depth),
            drfs_h0=drfs_h0,
            drfs_exact_leaf=bool(drfs_exact_leaf),
            # replay determinism: auto-seal timing and the eviction cutoff
            # both depend on these, so a restore under different settings
            # must be rejected, not silently diverge
            auto_seal=bool(auto_seal),
            horizon_s=horizon_s,
            n_edges=int(net.n_edges),
            n_lixels=int(self.lix.n_lixels),
            n_base_events=int(self.ee.n),
        )
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
        """(Re)bind the flush engine + plan cache for the requested
        ``(engine, executor)``: at construction, by ``restore`` (fresh
        device caches over the restored index) and by ``degrade``. A device
        engine that cannot be built raises: there is no fallback to the host
        path."""
        self.engine = "numpy"
        self._fe = None
        if self.mesh is not None:
            # sharding is explicit: never a silent single-device engine
            from .distributed import ShardedDynamicEngine, ShardedForestEngine

            cls = ShardedForestEngine if self.solution == "rfs" else ShardedDynamicEngine
            self._fe = cls(self.index, self.mesh, self.shard_axes)
            self.engine = "torch"
        elif self.solution in ("rfs", "drfs") and self._engine_req != "numpy":
            from .rfs import FlatDynamicEngine, FlatForestEngine

            cls = FlatForestEngine if self.solution == "rfs" else FlatDynamicEngine
            self._fe = cls(self.index, executor=self._executor_req, device=self.device,
                           codec=self.table_codec)
            self.engine = "torch"
        self._plan_cache = PlanCache(2)

    def degrade(self) -> Optional[str]:
        """Trip one rung down the executor ladder ``torch/packed@shards=N`` →
        ``torch/fused`` (or ``torch/kernel``) → ``torch/packed`` → ``numpy``
        (DESIGN.md §8): a sharded model first drops its mesh for the
        single-device packed executor on ``device``, as in the reference.

        Returns the new ``engine_desc``, or ``None`` when already on the
        floor. On the card the floor is ``torch/packed``: the ``numpy`` rung
        would move the work to the host while the tables stay on the card,
        so it is not taken. The serve tier calls this after repeated engine
        faults on the CPU only; on the card it is an operator's explicit
        call. Unlike the reference, a rung that cannot be built raises
        instead of landing on the floor, as every engine build of this
        package does.
        """
        if self._fe is None:
            return None
        if self.mesh is not None:
            self.mesh = None
            self._engine_req, self._executor_req = "torch", "packed"
        elif self._fe.executor in ("fused", "kernel", "search", "cascade"):
            self._engine_req, self._executor_req = "torch", "packed"
        elif self._fe.device.type != "cpu":
            return None
        else:
            self._engine_req, self._executor_req = "numpy", "auto"
        self._build_engine()
        return self.engine_desc

    # ------------------------------------------------------------------ API
    @property
    def n_lixels(self) -> int:
        return self.lix.n_lixels

    @property
    def engine_desc(self) -> str:
        """Human-readable backend/executor that actually answers queries,
        e.g. ``'torch/fused'``, ``'torch/kernel'``, ``'torch/packed'`` or
        ``'numpy'``; a sharded engine appends ``@shards=N``."""
        if self._fe is None:
            return "numpy"
        desc = f"{self.engine}/{self._fe.executor}"
        if self.mesh is not None:
            desc += f"@shards={self._fe.n_shards}"
        return desc

    @property
    def table_codec_used(self):
        """The ``torch_engine.TableCodec`` the device engine's window tables
        are stored in: its ``name`` ('f64', 'f32', 'bf16') and, where the
        narrow codec asked for could not hold the index and fell back to f64
        at build, its ``fallback_reason``. RFS ``executor='kernel'`` reads the
        raw forest: 'f64' whatever was asked. None on the host path
        (``engine='numpy'``, sps, ada), which keeps f64 host tables."""
        return None if self._fe is None else self._fe.codec

    @property
    def epoch(self):
        """(revision, pend_revision) of the index — (0, 0) for static ones."""
        if self.solution == "drfs":
            return self.index.epoch
        return (0, 0)

    def snapshot(self):
        """Pin the current index state as an immutable read handle (MVCC).

        For the streaming DRFS index this returns a :class:`drfs.DrfsSnapshot`
        that ``query(ts, at=snap)`` evaluates against, so inserts, seals and
        evictions issued after the pin are invisible to the query. Static
        indexes are immutable: the handle is ``None``.
        """
        if self.solution == "drfs":
            return self.index.snapshot()
        return None

    # ------------------------------------------------- planner event view
    @property
    def ee(self):
        """The planner's per-edge event view (candidate pruning, self-edge
        flags). Construction binds the full payload view (:class:`EdgeEvents`);
        streaming inserts/evictions only dirty the per-edge *counts*, and the
        view is lazily refreshed in O(E) as an :class:`EventCountsView` —
        never an O(N log N) re-merge per insert. Payloads live in the index;
        LS extremes live in ``ev_min_pos``/``ev_max_pos``."""
        if self._ee_dirty:
            ptr = np.zeros(self.net.n_edges + 1, np.int64)
            np.cumsum(self._ev_counts, out=ptr[1:])
            self._ee = EventCountsView(ptr=ptr, t_min=self._ee_tmin, t_max=self._ee_tmax)
            self._ee_dirty = False
        return self._ee

    @ee.setter
    def ee(self, value) -> None:
        self._ee = value
        self._ev_counts = np.diff(value.ptr).astype(np.int64)
        self._ee_tmin = float(value.t_min)
        self._ee_tmax = float(value.t_max)
        self._ee_dirty = False

    @property
    def stream_t_max(self) -> float:
        """Largest event timestamp seen so far — the stream clock
        ``compact()`` resolves the horizon cutoff against when the caller
        does not supply one."""
        return self._ee_tmax

    def _require_drfs(self, name: str) -> None:
        if self.solution != "drfs":
            raise ValueError(f"{name}() requires solution='drfs'")

    def insert(self, events: Events) -> None:
        """Streaming insertion (DRFS only, §5), vectorized over the batch.

        One O(batch) step: validation, one φ-moment pass, one DRFS pending
        append, and incremental per-dirty-edge planner updates (count bumps
        + extreme min/max). Invalid batches (bad edge id, out-of-range
        position, non-finite time) raise :class:`EventValidationError`
        before the WAL append and before any mutation. With a WAL attached,
        the validated batch is fsync'd to the log before any in-memory
        mutation — a crash at any later instant replays it (DESIGN.md §8).
        """
        self._require_drfs("insert")
        validate_events(self.net, events)
        if self._wal is not None and not self._replaying:
            self._wal.append_insert(events)
        ctx = self.ctx
        pos = events.pos  # validated in [0, edge_len] — no silent clipping
        lens = self.net.edge_len[events.edge_id]
        u_c = pos / lens
        sig = lens / ctx.b_s
        psi_c = ctx.ks.e_vec(u_c, sig)
        psi_d = ctx.ks.e_vec(1.0 - u_c, sig)
        v_l = (ctx.t_max - events.time) / ctx.t_span
        v_r = (events.time - ctx.t_min) / ctx.t_span
        tau_l = ctx.kt.e_vec(v_l, ctx.sigma_t)
        tau_r = ctx.kt.e_vec(v_r, ctx.sigma_t)
        n = events.n

        def outer(a, b):
            return (a[:, :, None] * b[:, None, :]).reshape(n, -1)

        phi = np.stack(
            [outer(psi_c, tau_l), outer(psi_c, tau_r), outer(psi_d, tau_l), outer(psi_d, tau_r)],
            axis=1,
        )
        self.index.insert(events.edge_id.astype(np.int64), pos, events.time, phi)
        # incremental planner update: O(batch) count/extreme bumps on the
        # dirty edges only — the counts view refreshes lazily in O(E)
        if n:
            np.add.at(self._ev_counts, events.edge_id, 1)
            tmin = float(events.time.min())
            tmax = float(events.time.max())
            if int(self._ev_counts.sum()) == n:  # first events ever seen
                self._ee_tmin, self._ee_tmax = tmin, tmax
            else:
                self._ee_tmin = min(self._ee_tmin, tmin)
                self._ee_tmax = max(self._ee_tmax, tmax)
            self._ee_dirty = True
            np.minimum.at(self.ev_min_pos, events.edge_id, pos)
            np.maximum.at(self.ev_max_pos, events.edge_id, pos)

    # --------------------------------------------- background compaction
    @property
    def needs_compaction(self) -> bool:
        """True when a ``compact()`` would do useful work: the geometric
        pending/sealed ratio crossed the seal threshold, or (with a
        horizon) events have expired."""
        if self.solution != "drfs":
            return False
        if self.index.needs_seal:
            return True
        if self.horizon_s is not None and self.index.n_sealed + self.index.n_pending:
            return self._ee_tmin < self._ee_tmax - self.horizon_s
        return False

    def compact(self, t_now: Optional[float] = None) -> dict:
        """One background-compaction step: evict expired events (sliding
        horizon), then seal the pending buffers into the tree.

        Runs off the insert path (with ``auto_seal=False`` insert never
        seals) and off the query path (MVCC: pinned snapshots keep answering
        over the pre-compaction arrays). ``t_now`` resolves the horizon
        cutoff ``t_now - horizon_s``; default is the stream clock
        ``stream_t_max``. After an eviction the device packs of older epochs
        are released at once. Eviction is not a pure function of event
        counts, so it is WAL-logged as an EVICT record carrying the resolved
        ``t_now`` before it applies; the seal is logged as usual. Returns
        ``{"evicted": n, "sealed": n}``.
        """
        self._require_drfs("compact")
        out = {"evicted": 0, "sealed": 0}
        if self.horizon_s is not None:
            t_now = self._ee_tmax if t_now is None else float(t_now)
            if self._ee_tmin < t_now - self.horizon_s and (
                self.index.n_sealed + self.index.n_pending
            ):
                if self._wal is not None and not self._replaying:
                    self._wal.append_evict(t_now)
                out["evicted"] = self._apply_evict(t_now)
        if self.index.n_pending:
            out["sealed"] = self.index.n_pending
            self.seal()
        if out["evicted"] and self._fe is not None:
            # drop device packs for pre-eviction epochs promptly so a
            # horizon-bounded run's device footprint plateaus
            self._fe.release_stale(self.index.epoch)
        return out

    def _apply_evict(self, t_now: float) -> int:
        """Apply (never log) the eviction for resolved stream time
        ``t_now`` — called by ``compact`` after logging, and by WAL replay
        for each EVICT record. Updates the planner's counts and per-edge
        extremes exactly for the touched edges, so post-eviction LS
        classification and replayed state stay exact."""
        cutoff = float(t_now) - self.horizon_s
        idx = self.index
        removed = idx.evict_before(cutoff)
        if removed is None:
            return 0
        self._ev_counts -= removed
        self._ee_dirty = True
        # recompute extremes for touched edges from the surviving events
        touched = np.nonzero(removed)[0]
        self.ev_min_pos[touched] = np.inf
        self.ev_max_pos[touched] = -np.inf
        cnts = np.diff(idx.ptr)
        sl = ragged_arange(idx.ptr[touched], cnts[touched])
        eo = np.repeat(touched, cnts[touched])
        np.minimum.at(self.ev_min_pos, eo, idx.pos[sl])
        np.maximum.at(self.ev_max_pos, eo, idx.pos[sl])
        t_lo = float(idx.time.min()) if idx.n_sealed else np.inf
        pcsr = idx.pending_csr()
        if pcsr is not None:
            pptr, pp, pt, _ = pcsr
            pe = np.repeat(np.arange(self.net.n_edges, dtype=np.int64), np.diff(pptr))
            m = removed[pe] > 0
            np.minimum.at(self.ev_min_pos, pe[m], pp[m])
            np.maximum.at(self.ev_max_pos, pe[m], pp[m])
            t_lo = min(t_lo, float(pt.min()))
        # advance the exact lower stream bound so needs_compaction / the
        # next compact() gate correctly (never stale-high)
        self._ee_tmin = t_lo if np.isfinite(t_lo) else self._ee_tmax
        return int(removed.sum())

    # ------------------------------------------- durability (DESIGN.md §8)
    def attach_wal(self, wal) -> None:
        """Log every subsequent mutation (``insert``/``seal``/``extend``/
        eviction) to ``wal`` before it takes effect in memory. DRFS only —
        the static solutions have no mutations to log."""
        self._require_drfs("attach_wal")
        self._wal = wal

    def seal(self) -> None:
        """Merge the pending buffers into the sealed tree (incremental:
        only dirty edges are re-aggregated), logged when a WAL is attached.
        The automatic geometric seal inside ``index.insert`` is not logged:
        its trigger is a pure function of event counts, so replaying the
        logged inserts re-fires it at the same points."""
        self._require_drfs("seal")
        if self._wal is not None and not self._replaying:
            self._wal.append_marker(_wal.KIND_SEAL)
        self.index.seal()

    def extend(self) -> None:
        """Add one index depth level (Algorithm 4), logged."""
        self._require_drfs("extend")
        if self._wal is not None and not self._replaying:
            self._wal.append_marker(_wal.KIND_EXTEND)
        self.index.extend()

    def checkpoint(self, ckpt_dir: str, *, step: Optional[int] = None, keep_last: int = 3,
                   blocking: bool = True) -> int:
        """Persist the sealed index through the atomic-COMMIT checkpoint
        layout (``repro_torch.ckpt``); returns the step written.

        Seals first (logged, so a crash during the save still replays
        consistently from the previous checkpoint), captures the index state
        tree with the planner's stream bounds and the config fingerprint,
        then — once the save committed — rotates the WAL and prunes the
        segments the new checkpoint covers. With ``blocking=False`` the
        arrays are captured by reference (safe: mutations rebind, never
        overwrite) and written on a worker thread; rotation still happens
        now, pruning waits for the next blocking checkpoint.
        """
        self._require_drfs("checkpoint")
        from ..ckpt import save_checkpoint

        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        self.seal()
        if step is not None:
            seq = int(step)  # coordinated checkpoint: the server picks the seq
        elif self._wal is not None:
            seq = self._wal.last_seq
        else:
            seq = self._ckpt_step + 1
        extras = {
            "seq": int(seq),
            "depth": int(self.index.depth),
            "revision": int(self.index.revision),
            "pend_revision": int(self.index.pend_revision),
            "ee_t_min": float(self._ee_tmin),
            "ee_t_max": float(self._ee_tmax),
            "n_events": int(self.index.n_sealed),
            "fingerprint": self._fingerprint,
        }
        self._ckpt_thread = save_checkpoint(ckpt_dir, seq, self.index.state_tree(),
                                            extras=extras, blocking=blocking,
                                            keep_last=keep_last)
        self._ckpt_step = seq
        if self._wal is not None:
            self._wal.rotate()
            if blocking:
                self._wal.prune(seq)
        return seq

    def restore(self, ckpt_dir=None, *, wal=None, attach: bool = True):
        """Crash recovery: rebind the latest committed checkpoint (if any),
        then replay the WAL suffix past its sequence number.

        Call on a freshly built model with the same configuration and base
        events as the crashed process — enforced through the config
        fingerprint stored in the checkpoint. With no committed checkpoint
        the whole log replays against the seed state. ``attach=True`` keeps
        logging to ``wal`` afterwards, so the recovered model is itself
        durable. Returns a :class:`wal.RecoveryReport`.
        """
        self._require_drfs("restore")
        t0 = _time.perf_counter()
        step = None
        seq0 = 0
        arrays = None
        if ckpt_dir is not None:
            from ..ckpt import load_checkpoint_arrays

            try:
                arrays, step, extras = load_checkpoint_arrays(ckpt_dir)
            except FileNotFoundError:
                arrays = None  # crashed before the first checkpoint committed
        if arrays is not None:
            fp = extras.get("fingerprint")
            if fp != self._fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: the checkpoint was taken "
                    f"under a different configuration ({fp!r} != {self._fingerprint!r})"
                )
            # leaves are keyed as "['ptr']" -> "ptr"
            tree = {k[2:-2]: v for k, v in arrays.items()}
            self.index.load_state(tree, depth=extras["depth"], revision=extras["revision"],
                                  pend_revision=extras["pend_revision"])
            # the sealed index arrays ARE the canonical (edge, time)-sorted
            # event set: rebind the planner's view from them by reference
            self.ee = EdgeEvents(ptr=self.index.ptr, pos=self.index.pos, time=self.index.time,
                                 t_min=float(extras["ee_t_min"]),
                                 t_max=float(extras["ee_t_max"]))
            E = self.net.n_edges
            self.ev_min_pos = np.full(E, np.inf)
            self.ev_max_pos = np.full(E, -np.inf)
            eo = np.repeat(np.arange(E), np.diff(self.index.ptr))
            if self.index.n_sealed:
                np.minimum.at(self.ev_min_pos, eo, self.index.pos)
                np.maximum.at(self.ev_max_pos, eo, self.index.pos)
            seq0 = int(extras["seq"])
            self._ckpt_step = step
            self._build_engine()  # fresh device caches over the restored state
        report = _wal.RecoveryReport(
            restored_step=step,
            from_seq=seq0,
            to_seq=seq0,
            n_truncated_bytes=wal.truncated_bytes if wal is not None else 0,
            restore_seconds=_time.perf_counter() - t0,
        )
        if wal is not None:
            t1 = _time.perf_counter()
            self._replaying = True
            try:
                for rec in wal.records(after_seq=seq0):
                    if rec.kind == _wal.KIND_INSERT:
                        self.insert(rec.events)
                        report.n_events += rec.events.n
                    elif rec.kind == _wal.KIND_SEAL:
                        self.index.seal()
                    elif rec.kind == _wal.KIND_EVICT:
                        # the record carries the resolved stream time; each
                        # model applies its own horizon cutoff (one server
                        # log serves profiles with different horizons)
                        if self.horizon_s is not None:
                            report.n_evicted += self._apply_evict(rec.t_now)
                    else:
                        self.index.extend()
                    report.n_records += 1
                    report.to_seq = rec.seq
            finally:
                self._replaying = False
            report.replay_seconds = _time.perf_counter() - t1
            if attach:
                self._wal = wal
        return report

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
            rows = bounded_dijkstra(net, verts, radius, adj=self._adj)
            vmap = {int(v): i for i, v in enumerate(verts)}
            for a in blk:
                ra = rows[vmap[int(net.edge_src[a])]]
                rb = rows[vmap[int(net.edge_dst[a])]]
                geom = build_edge_geometry(
                    net, lix, ee, int(a), ctx.b_s, np.stack([ra, rb])
                )
                if geom.x.shape[0]:
                    yield geom

    def _host_plan(self, snap=None):
        """The window-independent packed query plan for the pinned epoch.

        One planning walk (Dijkstra + geometry + atoms + LS classification)
        per (epoch, LS-mode), LRU-cached — a warm query skips planning
        entirely (DESIGN.md §7). ``snap`` (a DRFS snapshot) keys the plan on
        its epoch; the walk itself reads the live event view, a superset of
        the snapshot's events, which is conservative: extra candidate atoms
        evaluate to zero against the pinned index.
        """
        epoch = snap.epoch if snap is not None else self.epoch
        key = (epoch, self.ls)
        with obs.span("tnkde.plan") as sp:
            plan = self._plan_cache.get(key)
            if sp is not None:
                sp["hit"] = plan is not None
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

    def dispatch(self, ts: Sequence[float], *, at=None) -> "PendingQuery":
        """Begin a query asynchronously; returns a :class:`PendingQuery`.

        The host-side work — planning, window tables, atom packs — runs now,
        and the device flush is *enqueued* (CUDA launches are asynchronous),
        but the device→host transfer and the Lixel-Sharing dominated sweep
        are deferred to :meth:`PendingQuery.result`. ``at`` pins a
        :meth:`snapshot` as in :meth:`query`; the pinned epoch is captured
        before this call returns, so overlapping mutations stay invisible
        (MVCC). Host-only paths (numpy/sps) evaluate eagerly here;
        ``result()`` then returns the stored array.
        """
        if at is not None and self.solution != "drfs":
            raise ValueError("query(at=snapshot) requires solution='drfs'")
        ts = list(map(float, ts))
        query = next(_query_ids)
        with obs.span("tnkde.dispatch", query=query, windows=len(ts)):
            return self._dispatch(ts, at, query)

    def _dispatch(self, ts: List[float], at, query: int) -> "PendingQuery":
        W = len(ts)
        L = self.lix.n_lixels
        F = np.zeros((W, L))
        if W == 0:
            return PendingQuery(self, ts, F, query=query)
        snap = at
        if snap is None and self.solution == "drfs":
            snap = self.index.snapshot()
        idx = snap if snap is not None else self.index
        ee, ctx = self.ee, self.ctx
        if self.solution == "sps":
            for geom in self.edge_geometries():
                sl = slice(geom.lix_base, geom.lix_base + geom.x.shape[0])
                for w, t in enumerate(ts):
                    F[w, sl] += sps_eval_edge(geom, ee, ctx, t)
            return PendingQuery(self, ts, F, query=query)
        # ---- packed plan: atoms + dominated work, cached per epoch ---------
        plan = self._host_plan(snap)
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
            heat = self._fe.flush_plan(
                heat, plan, wb, tuple(ts),
                h0=self.drfs_h0, exact_leaf=self.drfs_exact_leaf, snapshot=snap,
            )
        else:
            for atoms in plan.blocks:
                for w, t in enumerate(ts):
                    if self.solution == "drfs":
                        vals = idx.eval_atoms(atoms, t, h0=self.drfs_h0,
                                              exact_leaf_scan=self.drfs_exact_leaf)
                    else:
                        vals = idx.eval_atoms(atoms, t, cascade=self.cascade)
                    np.add.at(F[w], atoms.lixel, vals)
        return PendingQuery(self, ts, F, query=query, heat=heat, idx=idx, plan=plan)

    def _consume_counters(self) -> None:
        """Fold the index/engine work counters into ``stats`` via cumulative
        cursors. Cursor-based (not bracketing snapshots) so overlapping
        in-flight dispatches never double-count — each unit of work is
        consumed by exactly one ``result()``; a counter that *shrank* means
        its owner was replaced (an engine swapped in) and the cursor resets
        with it."""

        def fold(counters, pairs):
            for name, stat in pairs:
                cur = int(counters[name])
                prev = self._counter_cursor.get(name, 0)
                if cur < prev:
                    prev = 0
                setattr(self.stats, stat, getattr(self.stats, stat) + cur - prev)
                self._counter_cursor[name] = cur

        if self.solution == "drfs":
            fold(self.index.counters, (("pending", "n_pending_scanned"),
                                       ("partial", "n_partial_scanned")))
        if self._fe is not None:
            fold(self._fe.counters, (("rank_searches", "n_rank_searches"),
                                     ("moment_gathers", "n_moment_gathers"),
                                     ("bytes_moved", "bytes_moved")))
            self.stats.bytes_per_shard = self._fe.bytes_per_shard

    def query(self, ts: Sequence[float], *, at=None) -> np.ndarray:
        """KDE values for every lixel, for each window center in ts: [W, L]
        float64. ``at`` pins the query to a :meth:`snapshot` handle (DRFS
        only): the result reflects exactly the event set visible when the
        snapshot was taken. ``at=None`` reads the latest revision (one
        snapshot is pinned per query internally, so a query never straddles
        a mutation). Equivalent to ``dispatch(ts, at=at).result()``."""
        return self.dispatch(ts, at=at).result()


class PendingQuery:
    """Handle to an in-flight :meth:`TNKDE.dispatch` (DESIGN.md §10).

    Holds the device-resident [L, W] heatmap whose flush is enqueued but not
    necessarily finished; :meth:`result` blocks on the device (the one
    device→host transfer), applies the host-side Lixel-Sharing dominated
    sweep against the pinned index view, folds the work counters into
    ``TNKDE.stats`` and returns the [W, L] array. Idempotent — repeated
    calls return the same materialized array. Host-path dispatches arrive
    here already evaluated.
    """

    __slots__ = ("_model", "_ts", "_F", "_query", "_heat", "_idx", "_plan", "_done")

    def __init__(self, model, ts, F, *, query: int, heat=None, idx=None, plan=None):
        self._model = model
        self._ts = ts
        self._F = F
        self._query = query  # the dispatch's id in the spans (repro_torch.obs)
        self._heat = heat
        self._idx = idx
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
        with obs.span("tnkde.result", query=self._query):
            if self._heat is not None:
                # the blocking device->host transfer (everything enqueued by
                # dispatch completes before the bytes land)
                with obs.span("tnkde.wait"):
                    self._F += model._fe.to_numpy(self._heat)
                self._heat = None
            # ---- Lixel Sharing: dominated edges, batched across the network ----
            if self._plan.dominated:
                dominated_sweep(self._F, self._idx, model.ctx, self._plan.dominated,
                                self._ts)
            model._consume_counters()
        model.stats.index_bytes = model.index.index_bytes
        self._done = True
        self._idx = self._plan = None  # drop the snapshot/plan pins
        return self._F
