"""Sharded TN-KDE: the packed-plan executor with sharding as a first axis.

Distribution scheme (DESIGN.md §3): the *index* — not the query — dominates
memory at fleet scale, so the packed position-major tables are slabbed
across shards and the packed executor runs unchanged on each slab:

  * edges are assigned to shards by greedy balanced packing over
    n_e log n_e work (:func:`assign_edges`); each shard holds a **rebased,
    compacted slab** of the ``torch_engine.PackedForest`` layout — per-shard
    tables address shard-LOCAL edge slots, so every table (values *and*
    metadata) scales ~1/shards. The host slabs (:func:`build_sharded_packed`)
    are bitwise the reference's;
  * query atoms come from the same cached host plans every executor uses; a
    plan block is routed once to the shard owning its edge
    (``query_plan.route_atoms_by_shard``) with local edge ids, and the
    window-independent root rank interval of every atom is resolved per
    shard and cached in the pack — the single-host plan contract;
  * per shard the window tables (``packed_node_tables``), the canonical walk
    (``eval_atoms_packed``) and the DRFS builders (``dyn_node_tables`` /
    ``dyn_window_tables`` / ``eval_atoms_dyn``) run verbatim on the shard's
    own tensors, and the shard adds its rows into its own [L, W] delta with
    the fixed-order scatter (``ops.segment_add``). The deltas are then added
    onto the heatmap in shard order — the stand-in for the reference's
    ``psum`` — so per-atom values are bitwise the single-host packed
    executor's and the heatmaps agree to summation-order noise (≤1e-12);
  * DRFS snapshots slab the same way per (revision, depth) epoch — sealed
    level CSRs and the pending-event CSR are shard-local, so streaming
    insert → seal → query works sharded with the MVCC contract of
    ``rfs.FlatDynamicEngine``.

Each shard's slab lives as its own tensors on its own device
(:class:`ShardMesh`): on several cards each holds 1/shards of the index; on
one card S slabs share it. Entry point: ``TNKDE(..., mesh=ShardMesh...)``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .aggregation import N_COMBOS, next_pow2
from .query_plan import PlanCache, route_atoms_by_shard
from .rfs import _DeviceEngine, _device_nbytes, _size_class
from .torch_engine import (
    FlatAtoms,
    FlatDynamicForest,
    PackedForest,
    TableCodec,
    WindowBatch,
    dyn_node_tables,
    dyn_window_tables,
    eval_atoms_dyn,
    eval_atoms_packed,
    packed_node_tables,
    packed_root_ranks,
)

__all__ = [
    "ShardMesh",
    "assign_edges",
    "ShardedPackedForest",
    "build_sharded_packed",
    "ShardedForestEngine",
    "ShardedDynamicEngine",
    "LoweredFlush",
]


class ShardMesh:
    """The devices the sharded engines put their slabs on, by named axis.

    ``shape`` maps each axis name to its extent (read as the reference reads
    a JAX mesh's ``shape``); ``devices`` lists one ``torch.device`` per mesh
    position, row-major over the axes. :meth:`on_one_device` puts S slabs on
    one device (on one H100: all on ``cuda``), :meth:`from_devices` one slab
    on each device of a list.
    """

    def __init__(self, devices, shape=None, axis_names=("data",)):
        devs = [torch.device(d) for d in devices]
        names = tuple(axis_names)
        shape = (len(devs),) if shape is None else tuple(int(n) for n in shape)
        if len(shape) != len(names) or math.prod(shape) != len(devs) or not devs:
            raise ValueError(f"ShardMesh: {len(devs)} devices do not fill the shape "
                             f"{dict(zip(names, shape))}")
        self.devices = devs
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    @classmethod
    def on_one_device(cls, n_shards: int, device="cuda", axis: str = "data"):
        """S = ``n_shards`` slabs, all on ``device``."""
        return cls([device] * max(int(n_shards), 1), axis_names=(axis,))

    @classmethod
    def from_devices(cls, devices, axis: str = "data"):
        """One slab on each device of ``devices``."""
        return cls(list(devices), axis_names=(axis,))

    def shard_devices(self, axes: Sequence[str]):
        """One device per shard over ``axes`` (row-major in the order given;
        the other axes at index 0, where the reference replicates)."""
        axes = tuple(axes)
        grid = np.arange(len(self.devices)).reshape(tuple(self.shape.values()))
        kept = [a for a in self.axis_names if a in axes]
        sub = grid[tuple(slice(None) if a in axes else 0 for a in self.axis_names)]
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return [self.devices[i] for i in sub.reshape(-1)]

    def __repr__(self):
        return f"ShardMesh({self.shape}, devices={[str(d) for d in self.devices]})"


def assign_edges(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy balanced edge→shard assignment by n log n work: [E] i64.

    Descending first-fit over the per-edge event counts. Degenerate cases
    yield valid (possibly empty) slabs: with more shards than edges some
    shards simply own nothing, and zero-event edges are given unit weight so
    they spread across shards instead of piling onto shard 0 (they carry no
    event tables, but they do occupy a local edge slot — round-robining them
    keeps the per-shard metadata width at ~E/S instead of E).
    """
    counts = np.asarray(counts, dtype=np.int64)
    n_shards = max(int(n_shards), 1)
    out = np.zeros(len(counts), np.int64)
    if len(counts) == 0:
        return out
    w = counts * np.maximum(np.log2(np.maximum(counts, 2)), 1.0)
    w = np.where(counts > 0, w, 1.0)
    order = np.argsort(-w, kind="stable")
    load = np.zeros(n_shards)
    for e in order:
        s = int(np.argmin(load))
        out[e] = s
        load[s] += w[e]
    return out


def _owned_lists(shard_of: np.ndarray, n_shards: int):
    """(owned edge-id list per shard, El = padded local edge capacity,
    edge_slot [E] global→local map). Owned lists are ascending, so local
    slot order matches global edge order within a shard."""
    owned = [np.nonzero(shard_of == s)[0] for s in range(n_shards)]
    El = max(max((len(o) for o in owned), default=0), 1)
    edge_slot = np.zeros(len(shard_of), np.int64)
    for o in owned:
        edge_slot[o] = np.arange(len(o))
    return owned, El, edge_slot


@dataclasses.dataclass
class ShardedPackedForest:
    """Stacked per-shard slabs of the packed position-major layout (host).

    Every array carries a leading shard axis; per-shard contents are the
    ``PackedForest`` tables of that shard's edges, rebased to the slab and
    addressed by shard-LOCAL edge slots (``edge_slot`` maps global edge ids;
    atoms are routed with local ids, so non-owned edges simply do not exist
    on a shard). Slabs are padded to the max across shards with +inf
    position/time pads and node-start slot 0 for the padding nodes (their
    folded values are never gathered by the walk). Bitwise the reference's.
    """

    pm_pos: np.ndarray  # [S, Pmax]
    pos_base: np.ndarray  # [S, El]
    pm_time: np.ndarray  # [S, Tmax]
    pm_cum: np.ndarray  # [S, Tmax, 4, K]
    edge_base: np.ndarray  # [S, El]
    n_pad: np.ndarray  # [S, El]
    n_lev: np.ndarray  # [S, El]
    node_base_lvl: np.ndarray  # [S, Lmax, El] walk level → local node base
    node_starts: Tuple[np.ndarray, ...]  # per level: [S, NLmax_lev] run offsets
    shard_of_edge: np.ndarray  # [E]
    edge_slot: np.ndarray  # [E] global edge → local slot on its shard
    events_per_shard: np.ndarray  # [S]
    max_levels: int
    search_steps: int
    steps_per_level: tuple
    n_shards: int
    n_nodes: int  # padded per-shard node count (uniform)


def build_sharded_packed(rf, n_shards: int) -> ShardedPackedForest:
    """Slab a built RangeForest's packed tables into per-shard rebased slabs.

    Builds the position-major host tables once (``rfs.build_packed_host_tables``
    — the transpose the single-host engine uploads) and relocates each
    edge's blocks into its shard's slab; node ids are re-assigned
    level-major within the shard with per-level blocks padded to the max
    across shards, so ``packed_node_tables``'s concatenated nodeval layout
    and ``node_base_lvl`` agree on every shard.
    """
    from .rfs import build_packed_host_tables

    host = build_packed_host_tables(rf)
    counts = np.diff(rf.ee.ptr)
    shard_of = assign_edges(counts, n_shards)
    S = max(int(n_shards), 1)
    owned, El, edge_slot = _owned_lists(shard_of, S)
    n_pad_g = np.asarray(host["n_pad"], np.int64)
    n_lev_g = np.asarray(host["n_lev"], np.int64)
    K = rf.ctx.K
    Lmax = max(rf.max_levels, 1)
    Pmax = max(max((int(n_pad_g[o].sum()) for o in owned), default=0), 1)
    Tmax = max(max((int((n_pad_g[o] * n_lev_g[o]).sum()) for o in owned), default=0), 1)
    nl_cnt = np.zeros((S, Lmax), np.int64)
    for s, o in enumerate(owned):
        for lev in range(Lmax):
            sel = o[n_lev_g[o] > lev]
            nl_cnt[s, lev] = int((n_pad_g[sel] >> lev).sum())
    NL = np.maximum(nl_cnt.max(axis=0, initial=0), 1)  # [Lmax] padded widths
    lev_base = np.concatenate([[0], np.cumsum(NL)])

    pm_pos = np.full((S, Pmax), np.inf)
    pm_time = np.full((S, Tmax), np.inf)
    pm_cum = np.zeros((S, Tmax, N_COMBOS, K))
    pos_base = np.zeros((S, El), np.int64)
    edge_base = np.zeros((S, El), np.int64)
    n_pad = np.zeros((S, El), np.int64)
    n_lev = np.zeros((S, El), np.int64)
    node_base_lvl = np.zeros((S, Lmax, El), np.int32)
    node_starts = [np.zeros((S, int(NL[lev])), np.int32) for lev in range(Lmax)]
    for s, o in enumerate(owned):
        p_off = t_off = 0
        n_off = np.zeros(Lmax, np.int64)
        for j, e in enumerate(o):
            npd, nlv = int(n_pad_g[e]), int(n_lev_g[e])
            n_pad[s, j] = npd
            n_lev[s, j] = nlv
            if npd == 0:
                continue
            gp, gt = int(host["pos_base"][e]), int(host["edge_base"][e])
            pm_pos[s, p_off : p_off + npd] = host["pm_pos"][gp : gp + npd]
            pos_base[s, j] = p_off
            p_off += npd
            blk = npd * nlv
            pm_time[s, t_off : t_off + blk] = host["pm_time"][gt : gt + blk]
            pm_cum[s, t_off : t_off + blk] = host["pm_cum"][gt : gt + blk]
            edge_base[s, j] = t_off
            for lev in range(nlv):
                nb = npd >> lev
                node_base_lvl[s, lev, j] = lev_base[lev] + n_off[lev]
                node_starts[lev][s, n_off[lev] : n_off[lev] + nb] = (
                    t_off + lev * npd + np.arange(nb, dtype=np.int64) * (1 << lev)
                )
                n_off[lev] += nb
            t_off += blk
    ev_per_shard = np.bincount(shard_of, weights=counts.astype(np.float64), minlength=S)
    return ShardedPackedForest(
        pm_pos=pm_pos,
        pos_base=pos_base,
        pm_time=pm_time,
        pm_cum=pm_cum,
        edge_base=edge_base,
        n_pad=n_pad,
        n_lev=n_lev,
        node_base_lvl=node_base_lvl,
        node_starts=tuple(node_starts),
        shard_of_edge=shard_of,
        edge_slot=edge_slot,
        events_per_shard=ev_per_shard.astype(np.int64),
        max_levels=Lmax,
        search_steps=max(int(np.ceil(np.log2(max(int(n_pad_g.max(initial=1)), 1) + 1))) + 1, 1),
        steps_per_level=tuple(host["steps_per_level"]),
        n_shards=S,
        n_nodes=int(lev_base[-1]),
    )


class _ShardedBase(_DeviceEngine):
    """Shared plumbing of the sharded engines: the single-host device
    plumbing (window batches, heatmap on the first shard's device,
    device→host transfer, counters) plus the mesh, per-shard uploads, the
    shard-order sum of the per-shard deltas and per-shard accounting."""

    executor = "packed"

    def _init_mesh(self, mesh, axes: Sequence[str]):
        self.mesh = mesh
        self.axes = tuple(axes)
        missing = [a for a in self.axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"mesh has no axes {missing}; got {dict(mesh.shape)}")
        self.n_shards = int(math.prod(mesh.shape[a] for a in self.axes))
        self.shard_devices = mesh.shard_devices(self.axes)
        self._init_device(self.shard_devices[0])  # the heatmap's; raises with no card
        self.codec = TableCodec("f64")  # the slabs are f64 (no table codec)
        self._shard_wbs = PlanCache(8 * len(set(self.shard_devices)))
        self._mesh_key = (tuple(sorted(mesh.shape.items())), self.axes)

    def _put(self, x, s, dtype=None, device=None):
        """Host array → a tensor on shard ``s``'s device, or on ``device``
        (non-blocking)."""
        t = torch.as_tensor(np.ascontiguousarray(x)).to(device or self.shard_devices[s],
                                                       non_blocking=True)
        return t if dtype is None else t.to(dtype)

    def _shard_wb(self, wb, ts_key, s):
        """The window batch on shard ``s``'s device (a cached copy when that
        is not the heatmap's device)."""
        dev = self.shard_devices[s]
        if dev == self.device:
            return wb
        key = (ts_key, str(dev))
        hit = self._shard_wbs.get(key)
        if hit is None:
            hit = WindowBatch(*(t.to(dev, non_blocking=True) for t in wb))
            self._shard_wbs.put(key, hit)
        return hit

    def _route(self, atoms, shard_of, edge_slot, device=None):
        """A plan block routed to its shards: per shard the device FlatAtoms
        (local edge ids) and the segment index of its real rows (on
        ``device`` instead of the shards' own when given)."""
        fields = route_atoms_by_shard(atoms, shard_of, edge_slot, self.n_shards)
        out = []
        for s in range(self.n_shards):
            f = {k: v[s] for k, v in fields.items()}
            put = lambda k, dt: self._put(f[k], s, dt, device)  # noqa: E731
            fa = FlatAtoms(
                lixel=put("lixel", torch.int64),
                edge=put("edge", torch.int64),
                side_feat=put("side_feat", torch.int32),
                qs=put("qs", torch.float64),
                pos_hi=put("pos_hi", torch.float64),
                pos_lo1=put("pos_lo1", torch.float64),
                lo1_right=put("lo1_right", torch.bool),
                pos_lo2=put("pos_lo2", torch.float64),
                valid=put("valid", torch.bool),
            )
            slots = np.flatnonzero(f["valid"])
            seg = ops.segment_index(f["lixel"][slots], slots,
                                    device=device or self.shard_devices[s])
            out.append(dict(fa=fa, seg=seg))
        return out

    def _add_deltas(self, heat, vals_per_shard, shards):
        """Each shard adds its rows ([Wh, Mp] values, window halves folded)
        into its own [L, W] delta with the fixed-order scatter; the deltas
        are then added onto ``heat`` in shard order."""
        L, W = heat.shape
        deltas = []
        for s, vals in enumerate(vals_per_shard):
            if vals is None:
                continue
            delta = torch.zeros((L, W), dtype=torch.float64, device=self.shard_devices[s])
            deltas.append(ops.segment_add(delta, vals.T, shards[s]["seg"], halves=True))
        for delta in deltas:
            heat.add_(delta.to(heat.device, non_blocking=True))
        return heat

    def _shard_parts(self, s):
        raise NotImplementedError

    @property
    def device_bytes(self) -> int:
        """Device bytes of every shard's tables and cached plans, summed."""
        return sum(_device_nbytes(self._shard_parts(s)) for s in range(self.n_shards))

    @property
    def bytes_per_shard(self) -> int:
        """Device bytes of the heaviest shard (its slab, window tables and
        atom packs): the measured counterpart of the 1/shards memory
        scaling, surfaced as ``QueryStats.bytes_per_shard``."""
        return max(_device_nbytes(self._shard_parts(s)) for s in range(self.n_shards))


class ShardedForestEngine(_ShardedBase):
    """Sharded packed-plan query engine over a built RangeForest.

    The :class:`rfs.FlatForestEngine` contract (window_batch / new_heatmap /
    flush_plan / to_numpy / counters / device_bytes) over per-shard slabs of
    the same position-major layout: per shard the canonical
    ``eval_atoms_packed`` walk — verbatim the single-host executor — into a
    per-shard delta, the deltas then summed onto the heatmap in shard order.
    Window tables per ts tuple, atom packs (with cached per-shard root rank
    intervals) per host plan, both keyed with the mesh.
    """

    def __init__(self, rf, mesh, axes: Sequence[str] = ("data",)):
        self._init_mesh(mesh, axes)
        self.rf = rf
        self.sf = sf = build_sharded_packed(rf, self.n_shards)
        self.max_levels = sf.max_levels
        self.search_steps = sf.search_steps
        # every slab's node starts share one level split (padded per level)
        self._lvl_ptr = tuple(np.cumsum([0] + [ns.shape[1] for ns in sf.node_starts]).tolist())
        self._pf, self._nbl, self._starts = [], [], []
        for s in range(self.n_shards):
            pf, starts = self._slab(s)
            self._nbl.append(pf.node_base)
            self._pf.append(pf)
            self._starts.append(starts)
        self._tab_cache = PlanCache(2)
        self._pack_cache = PlanCache(2)

    def _slab(self, s, device=None):
        """Shard ``s``'s slab on its device (or on ``device``): the
        ``PackedForest`` and the node starts, flat and level-major (levels
        split at ``self._lvl_ptr``)."""
        sf = self.sf
        put = lambda a, dt=None: self._put(a[s], s, dt, device)  # noqa: E731
        nbl = put(sf.node_base_lvl, torch.int64)
        pf = PackedForest(
            pm_pos=put(sf.pm_pos), pos_base=put(sf.pos_base), pm_time=put(sf.pm_time),
            pm_cum=put(sf.pm_cum), edge_base=put(sf.edge_base), n_pad=put(sf.n_pad),
            n_lev=put(sf.n_lev),
            # no sharded step reads pf.node_base (the walk takes the
            # level-major node bases): the one buffer serves both, and the
            # accounting counts it once
            node_base=nbl,
        )
        starts = self._put(np.concatenate([ns[s] for ns in sf.node_starts]), s, torch.int64,
                           device)
        return pf, starts

    def _shard_parts(self, s):
        return [self._pf[s], self._starts[s],
                [t[s] for t in self._tab_cache.values()],
                [e["shards"][s] for packs in self._pack_cache.values() for e in packs]]

    def window_tables(self, wb, ts_key):
        """Per-shard q_t-folded node values [R·2, W, 2k_s], LRU per ts: the
        single-host hoist and builder (``packed_node_tables``) over each
        slab's node runs."""
        key = (ts_key, self._mesh_key)
        hit = self._tab_cache.get(key)
        if hit is not None:
            return hit
        W = len(ts_key)
        l0 = ops.fold_node_tables.launches
        tabs = [packed_node_tables(self._pf[s], self._shard_wb(wb, ts_key, s), self._starts[s],
                                   lvl_ptr=self._lvl_ptr, steps_per_level=self.sf.steps_per_level,
                                   k_t=int(self.rf.ctx.k_t))
                for s in range(self.n_shards)]
        self.counters["fold_launches"] += ops.fold_node_tables.launches - l0
        nn = self.sf.n_nodes * self.n_shards
        self.counters["rank_searches"] += 3 * W * nn
        self.counters["moment_gathers"] += 3 * W * nn
        self._tab_cache.put(key, tabs)
        return tabs

    def _atom_packs(self, plan):
        """Per-block routed atom packs with cached per-shard root ranks."""
        key = (plan.key, self._mesh_key)
        hit = self._pack_cache.get(key)
        if hit is not None:
            return hit
        packs = []
        for atoms in plan.blocks:
            shards = self._route(atoms, self.sf.shard_of_edge, self.sf.edge_slot)
            for s, sh in enumerate(shards):
                sh["r_lo"], sh["r_hi"] = packed_root_ranks(self._pf[s], sh["fa"],
                                                           search_steps=self.search_steps)
            packs.append(dict(shards=shards, m=atoms.m))
        self._pack_cache.put(key, packs)
        return packs

    def flush_plan(self, heat, plan, wb, ts_key, **_):
        """heat[L, W] += every atom block, all shards, deltas in shard order."""
        if plan.n_atoms == 0:
            return heat
        tabs = self.window_tables(wb, ts_key)
        for entry in self._atom_packs(plan):
            vals = [None if sh["seg"].n_rows == 0 else
                    eval_atoms_packed(tabs[s], self._nbl[s], sh["fa"], sh["r_lo"], sh["r_hi"],
                                      max_levels=self.max_levels)  # [Wh, Mp]
                    for s, sh in enumerate(entry["shards"])]
            self._add_deltas(heat, vals, entry["shards"])
            self.counters["moment_gathers"] += 2 * self.max_levels * entry["m"]
        return heat

    def lower_flush(self, wb, plan, n_lixels: int) -> "LoweredFlush":
        """Account :meth:`flush_plan` of ``plan`` over the windows of ``wb``
        without running it (the reference's dry-run hook, which lowers the
        sharded flush for the production meshes): per shard the slab, the
        window table at this ``wb``'s W, every block's routed atom pack with
        its root ranks and segment index, and the ``[L, W]`` delta; the
        ``segment_add`` launches the flush makes (one per block and shard
        with rows). Built from the host slabs (``self.sf``, bitwise the
        reference's) and the plan on the meta device: no device work and no
        table is allocated, so it also serves a mesh of meta positions
        (``launch.mesh.make_production_mesh``). Each shard's bytes equal
        ``_device_nbytes(self._shard_parts(s))`` after a real flush of the
        plan. Against the reference's stacked arrays over S, the slab
        differs in two arrays: ``node_base_lvl`` and ``node_starts`` are
        int64 here (the walk and the table builder add them to int64 edge,
        rank and row indices), int32 there."""
        meta = torch.device("meta")
        W = int(wb.t_lo.shape[0]) // 2
        k_s = int(self.rf.ctx.k_s)
        table = torch.empty((self.sf.n_nodes * 2, W, 2 * k_s), dtype=torch.float64, device=meta)
        blocks = [self._route(atoms, self.sf.shard_of_edge, self.sf.edge_slot, device=meta)
                  for atoms in plan.blocks]
        shards = []
        for s in range(self.n_shards):
            pf, starts = self._slab(s, meta)
            # the reference's slab holds one node-start array a level
            ns = torch.split(starts, np.diff(self._lvl_ptr).tolist())
            packs = []
            for b in blocks:
                sh = dict(b[s])
                M = sh["fa"].edge.shape[0]
                sh["r_lo"] = torch.empty(M, dtype=torch.int32, device=meta)
                sh["r_hi"] = torch.empty(M, dtype=torch.int32, device=meta)
                packs.append(sh)
            shards.append(dict(slab=(pf, ns), table=table, packs=packs))
        return LoweredFlush(shards, n_lixels=int(n_lixels), n_windows=W)


class LoweredFlush:
    """The account of one sharded flush (``ShardedForestEngine.lower_flush``):
    per shard ``args`` — name → (shape, dtype, bytes) of every tensor the
    flush reads (the slab, the window table, each block's atom pack, root
    ranks and segment index) — and ``slab_bytes``, ``table_bytes``,
    ``pack_bytes``, ``bytes`` (their sum: the shard's device bytes after the
    flush) and ``delta_bytes`` (its ``[L, W]`` float64 delta, temporary);
    ``n_shards``; ``bytes_per_shard`` and ``slab_bytes_per_shard`` (the
    heaviest shard's); ``argument_bytes`` (the heaviest shard's bytes and
    the ``[L, W]`` heatmap) and ``temp_bytes`` (one shard's delta), the
    reference's memory analysis; ``launches`` (``segment_add``, one per
    block and shard with rows); ``collectives``: the shard-order sum of the
    deltas, the stand-in for the reference's ``psum`` (its result: one
    ``[L, W]`` float64)."""

    def __init__(self, shards, *, n_lixels: int, n_windows: int):
        from .rfs import _device_nbytes

        self.n_shards = len(shards)
        self.n_lixels, self.n_windows = n_lixels, n_windows
        self.shards = []
        for sh in shards:
            pf, ns = sh["slab"]
            args = {f"slab.{k}": v for k, v in pf._asdict().items() if k != "node_base"}
            args["slab.node_base_lvl"] = pf.node_base  # one buffer serves both
            args.update({f"slab.node_starts[{i}]": t for i, t in enumerate(ns)})
            args["window_table"] = sh["table"]
            for b, pack in enumerate(sh["packs"]):
                args.update({f"pack[{b}].fa.{k}": v for k, v in pack["fa"]._asdict().items()})
                args.update({f"pack[{b}].{k}": pack[k] for k in ("r_lo", "r_hi")})
                args.update({f"pack[{b}].seg.{k}": getattr(pack["seg"], k)
                             for k in ("rows", "seg_ptr", "lixel", "blk_seg", "blk_row")})
            slab = _device_nbytes([pf, list(ns)])
            table = _device_nbytes(sh["table"])
            packs = _device_nbytes(sh["packs"])
            self.shards.append(dict(
                args={k: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                          t.numel() * t.element_size()) for k, t in args.items()},
                slab_bytes=slab, table_bytes=table, pack_bytes=packs,
                bytes=slab + table + packs, delta_bytes=n_lixels * n_windows * 8,
                launches=sum(p["seg"].n_rows > 0 for p in sh["packs"])))
        self.bytes_per_shard = max(s["bytes"] for s in self.shards)
        self.slab_bytes_per_shard = max(s["slab_bytes"] for s in self.shards)
        self.launches = sum(s["launches"] for s in self.shards)
        heat = n_lixels * n_windows * 8
        self.argument_bytes = self.bytes_per_shard + heat
        self.temp_bytes = max(s["delta_bytes"] for s in self.shards)
        self.collectives = {"all-reduce": heat, "total": heat}


class _ShardedSealed:
    """Per-shard device tables of one sealed structure epoch."""

    __slots__ = ("tables", "n_levels", "max_occ")


class _ShardedPend:
    """Per-shard device tables of one pending-buffer epoch."""

    __slots__ = ("tables", "pend_steps")


class ShardedDynamicEngine(_ShardedBase):
    """Sharded streaming DRFS engine — ``rfs.FlatDynamicEngine`` over slabs.

    Mutations stay on the host (``drfs.py``); this engine slabs **per
    snapshot epoch**: sealed level CSRs and event tables are compacted to
    each shard's owned edges (shard-local ``node_ptr`` over El local edge
    slots, so ``eval_atoms_dyn`` and the ``dyn_*`` table builders run
    verbatim per shard), and the pending CSR is sliced the same way —
    insert → query never rebuilds, the single-host MVCC contract. Both
    modes (quantized and exact leaf). Shard assignment is fixed at
    construction from the initial per-edge event counts; streamed events
    follow their edge's shard.
    """

    def __init__(self, df, mesh, axes: Sequence[str] = ("data",), *, max_snapshots: int = 2):
        self._init_mesh(mesh, axes)
        self.df = df
        self.max_snapshots = max(int(max_snapshots), 1)
        S = self.n_shards
        self.shard_of = assign_edges(np.diff(df.ptr), S)
        self._owned, self.El, self.edge_slot = _owned_lists(self.shard_of, S)
        self._own_mask = [np.zeros(df.net.n_edges, bool) for _ in range(S)]
        for s, o in enumerate(self._owned):
            self._own_mask[s][o] = True
        self._lens = []
        for s, o in enumerate(self._owned):
            lens_local = np.ones(self.El)
            lens_local[: len(o)] = df.lens[o]
            self._lens.append(self._put(lens_local, s))
        self._sealed_packs: "OrderedDict" = OrderedDict()
        self._pend_packs: "OrderedDict" = OrderedDict()
        self._tab_cache: "OrderedDict" = OrderedDict()
        self._pack_cache = PlanCache(2)
        snap = df.snapshot()
        self._get_sealed(snap)
        self._get_pending(snap)

    def _shard_parts(self, s):
        return [self._lens[s],
                [p.tables[s] for p in self._sealed_packs.values()],
                [p.tables[s] for p in self._pend_packs.values()],
                [t[s] for t in self._tab_cache.values()],
                [e["shards"][s] for packs in self._pack_cache.values() for e in packs]]

    # ------------------------------------------------------------- packing
    def _get_sealed(self, snap) -> _ShardedSealed:
        """Per-shard sealed level tables for the snapshot's structure epoch."""
        key = (snap.revision, snap.depth)
        pack = self._sealed_packs.get(key)
        if pack is not None:
            self._sealed_packs.move_to_end(key)
            return pack
        S, El = self.n_shards, self.El
        E = snap.net.n_edges
        Lv = snap.depth + 1
        K = snap.ctx.K
        edge_of_event = np.repeat(np.arange(E, dtype=np.int64), np.diff(snap.ptr))
        n_s = (np.bincount(self.shard_of[edge_of_event], minlength=S) if len(edge_of_event)
               else np.zeros(S, np.int64))
        Np = _size_class(max(int(n_s.max(initial=1)), 1))
        time_lvl = np.full((S, Lv * Np), np.inf)
        pos_lvl = np.full((S, Lv * Np), np.inf)
        cum_lvl = np.zeros((S, Lv * Np, N_COMBOS, K))
        ptr_len = sum(El * (1 << d) + 1 for d in range(Lv))
        node_ptr = np.zeros((S, ptr_len), np.int64)
        max_occ = np.zeros(Lv, np.int64)
        for d, (nptr, tms, cum, eidx) in enumerate(snap.levels):
            cnt = np.diff(nptr).reshape(E, 1 << d)
            eos = edge_of_event[eidx] if len(eidx) else eidx
            off_d = El * ((1 << d) - 1) + d
            for s, o in enumerate(self._owned):
                sel = np.nonzero(self._own_mask[s][eos])[0] if len(eos) else eos
                k = len(sel)
                time_lvl[s, d * Np : d * Np + k] = tms[sel]
                pos_lvl[s, d * Np : d * Np + k] = snap.pos[eidx[sel]]
                cum_lvl[s, d * Np : d * Np + k] = cum[sel]
                cl = np.zeros((El, 1 << d), np.int64)
                cl[: len(o)] = cnt[o]
                np.cumsum(cl.ravel(), out=node_ptr[s, off_d + 1 : off_d + El * (1 << d) + 1])
                max_occ[d] = max(max_occ[d], int(cl.max(initial=0)))
        pack = _ShardedSealed()
        pack.tables = [dict(time_lvl=self._put(time_lvl[s], s), pos_lvl=self._put(pos_lvl[s], s),
                            cum_lvl=self._put(cum_lvl[s], s), node_ptr=self._put(node_ptr[s], s),
                            edge_len=self._lens[s])
                       for s in range(S)]
        pack.n_levels = Lv
        pack.max_occ = max_occ
        self._sealed_packs[key] = pack
        while len(self._sealed_packs) > self.max_snapshots:
            old_key, _ = self._sealed_packs.popitem(last=False)
            for tk in [k for k in self._tab_cache if k[1:3] == old_key]:
                del self._tab_cache[tk]
        return pack

    def _get_pending(self, snap) -> _ShardedPend:
        """Per-shard pending-CSR tables for the snapshot's pending epoch."""
        key = snap.pend_revision
        pack = self._pend_packs.get(key)
        if pack is not None:
            self._pend_packs.move_to_end(key)
            return pack
        S, El = self.n_shards, self.El
        E = snap.net.n_edges
        K = snap.ctx.K
        csr = snap.pending_csr()
        pack = _ShardedPend()
        if csr is None:
            pptr = np.zeros((S, El + 1), np.int64)
            pp = np.zeros((S, 1))
            pt = np.full((S, 1), np.inf)
            pf = np.zeros((S, 1, N_COMBOS, K))
            pack.pend_steps = 0
        else:
            gptr, gp, gt, gf = csr
            counts = np.diff(gptr)
            edge_of = np.repeat(np.arange(E, dtype=np.int64), counts)
            per_shard = np.bincount(self.shard_of[edge_of], minlength=S)
            Pp = _size_class(max(int(per_shard.max(initial=1)), 1), floor=64)
            pptr = np.zeros((S, El + 1), np.int64)
            pp = np.zeros((S, Pp))
            pt = np.full((S, Pp), np.inf)
            pf = np.zeros((S, Pp, N_COMBOS, K))
            for s, o in enumerate(self._owned):
                sel = np.nonzero(self._own_mask[s][edge_of])[0]
                k = len(sel)
                pp[s, :k] = gp[sel]
                pt[s, :k] = gt[sel]
                pf[s, :k] = gf[sel]
                cl = np.zeros(El, np.int64)
                cl[: len(o)] = counts[o]
                np.cumsum(cl, out=pptr[s, 1:])
            pack.pend_steps = next_pow2(int(counts.max(initial=1)))
        pack.tables = [dict(pend_ptr=self._put(pptr[s], s), pend_pos=self._put(pp[s], s),
                            pend_time=self._put(pt[s], s), pend_phi=self._put(pf[s], s))
                       for s in range(S)]
        self._pend_packs[key] = pack
        while len(self._pend_packs) > self.max_snapshots + 2:
            self._pend_packs.popitem(last=False)
        return pack

    def release_stale(self, epoch) -> int:
        """Drop packs (and their window tables) of epochs strictly older than
        ``epoch = (revision, pend_revision)``, as
        ``rfs.FlatDynamicEngine.release_stale``: a pinned snapshot that
        queries later re-packs from its own arrays."""
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

    def _forest(self, sealed: _ShardedSealed, pend: _ShardedPend, s: int):
        return FlatDynamicForest(**sealed.tables[s], **pend.tables[s])

    # ------------------------------------------------------------ per query
    def window_tables(self, wb, ts_key, snap, sealed: _ShardedSealed, hq: int, exact: bool):
        """Per-shard window tables for (ts, structure epoch, hq, mode), LRU:
        the single-host builders over each shard's local CSRs."""
        key = (ts_key, snap.revision, snap.depth, int(hq), bool(exact), self._mesh_key)
        hit = self._tab_cache.get(key)
        if hit is not None:
            self._tab_cache.move_to_end(key)
            return hit

        def steps(occ):
            return max(int(np.ceil(np.log2(int(occ) + 1))) + 1, 1)

        W = len(ts_key)
        pend = self._get_pending(snap)
        tabs = []
        for s in range(self.n_shards):
            forest = self._forest(sealed, pend, s)
            swb = self._shard_wb(wb, ts_key, s)
            if exact:
                spl = tuple(steps(o) for o in sealed.max_occ[: hq + 1])
                tabs.append((dyn_node_tables(forest, swb, n_levels=sealed.n_levels, hq=int(hq),
                                             steps_per_level=spl),))
            else:
                tabs.append((dyn_window_tables(forest, swb, n_levels=sealed.n_levels, hq=int(hq),
                                               search_steps=steps(sealed.max_occ[hq])),))
        nn = self.El * (((1 << (hq + 1)) - 1) if exact else (1 << hq)) * self.n_shards
        self.counters["rank_searches"] += 3 * W * nn
        self.counters["moment_gathers"] += 3 * W * nn
        self._tab_cache[key] = tabs
        while len(self._tab_cache) > 4 * self.max_snapshots:
            self._tab_cache.popitem(last=False)
        return tabs

    def _atom_packs(self, plan):
        """Per-block routed atom packs (local edge ids), per host plan."""
        key = (plan.key, self._mesh_key)
        hit = self._pack_cache.get(key)
        if hit is not None:
            return hit
        packs = [dict(shards=self._route(atoms, self.shard_of, self.edge_slot), atoms=atoms,
                      m=atoms.m) for atoms in plan.blocks]
        self._pack_cache.put(key, packs)
        return packs

    def flush_plan(self, heat, plan, wb, ts_key, *, h0=None, exact_leaf=False,
                   snapshot=None, **_):
        """heat[L, W] += every atom block, snapshot-consistent, all shards."""
        if plan.n_atoms == 0:
            return heat
        snap = snapshot if snapshot is not None else self.df.snapshot()
        sealed = self._get_sealed(snap)
        pend = self._get_pending(snap)
        hq = snap.depth if h0 is None else min(int(h0), snap.depth)
        scan_steps = 0
        if exact_leaf:
            occ = int(sealed.max_occ[hq])
            scan_steps = -(-occ // 8) * 8 if occ else 0
        W = heat.shape[1]
        tables = self.window_tables(wb, ts_key, snap, sealed, hq, bool(exact_leaf))
        kw = dict(n_levels=sealed.n_levels, hq=int(hq), scan_steps=int(scan_steps),
                  pend_steps=int(pend.pend_steps), exact=bool(exact_leaf))
        for entry in self._atom_packs(plan):
            atoms = entry["atoms"]
            snap.counters["pending"] += snap.pending_scan_pairs(atoms) * W
            if exact_leaf:
                snap.counters["partial"] += snap.partial_scan_pairs(atoms, hq) * 2 * W
            self.counters["moment_gathers"] += (
                2 * (hq + 1) * entry["m"] if exact_leaf else 2 * entry["m"]
            )
            vals = [None if sh["seg"].n_rows == 0 else
                    eval_atoms_dyn(self._forest(sealed, pend, s), sh["fa"],
                                   self._shard_wb(wb, ts_key, s), tables[s], **kw)
                    for s, sh in enumerate(entry["shards"])]
            self._add_deltas(heat, vals, entry["shards"])
        return heat
