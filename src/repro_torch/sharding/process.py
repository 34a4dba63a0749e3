"""Training over several processes: a mesh whose positions are the ranks of
a ``torch.distributed`` group, the block of every array each rank holds, and
the collectives the train step runs on those blocks (ROADMAP A12).

The reference trains under a JAX mesh: XLA's partitioner places each array
by its ``NamedSharding`` and inserts the collectives, so this module has no
file of its own there. The port runs one process per device instead:

* :func:`init_group` joins this process to the group, from an address, a
  rank, a world size and a backend given explicitly (no environment
  variable is read), every collective bounded by a timeout, so a rank that
  fails makes the others raise rather than hang;
* :class:`ProcessMesh` is a ``core.distributed.ShardMesh`` whose positions
  are the group's ranks, row-major over the reference's axis names
  (``data``, ``model``; ``pod``, ``data``, ``model`` for multi-pod). It
  makes one sub-group per set of axes, each rank calling ``new_group`` for
  every sub-group in the same order, and runs the collectives over them,
  on the tensors where they lie: gloo (torch 2.11) runs each one the step
  needs on CUDA tensors itself, through host memory (its transport is TCP),
  and the bytes it so moves are counted in ``host_staged_bytes``; NCCL
  moves none through the host;
* :class:`Blocks` is the port's ``NamedSharding``: an array's spec
  (``sharding.rules.logical_spec``) on a ``ProcessMesh``, the block this
  rank holds (in the reference's block order: along each dimension, the
  coordinate over the spec entry's axes in the order the entry names them)
  and the all-gather / reduce-scatter between block and whole array;
* :func:`param_blocks` / :func:`state_blocks` give the blocks of a model's
  parameters and AdamW state under a profile; :func:`spawn_ranks` starts a
  group of processes on this host and returns what each rank returned.
"""
from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import ShardMesh
from repro_torch.sharding.rules import logical_spec, spec_axes

__all__ = ["init_group", "ProcessMesh", "Blocks", "gather_leaf", "param_blocks",
           "state_blocks", "take_blocks", "gather_tree", "tree_nbytes", "free_address",
           "spawn_ranks"]

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: ``'cpu'``, ``'cuda:i'``, or ``'cuda'`` → card
    ``rank % device_count()`` (one process per card)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("process group: no CUDA device; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"process group: a rank runs on 'cpu' or 'cuda[:i]', not {dev}")
    return dev


def init_group(*, address: str, rank: int, world: int, backend: str, device="cuda",
               timeout_s: float = 300.0) -> torch.device:
    """Join rank ``rank`` of ``world`` processes at ``address`` (``host:port``,
    where rank 0 listens) over ``backend`` (``'nccl'`` or ``'gloo'``); every
    collective of the group raises after ``timeout_s`` seconds. Returns this
    rank's device (``'cuda'`` becomes card ``rank % device_count()``)."""
    if backend not in BACKENDS:
        raise ValueError(f"process group: backend {backend!r} is not one of {BACKENDS}")
    if not 0 <= rank < world:
        raise ValueError(f"process group: rank {rank} outside a world of {world}")
    dev = _rank_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("process group: nccl needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _groups_over(grid: np.ndarray, names: Sequence[str], axes: Sequence[str]):
    """The rank lists of every sub-group over ``axes`` (each list row-major
    over ``axes`` in mesh order, so ascending), the other axes' coordinates
    row-major."""
    rest = [i for i, a in enumerate(names) if a not in axes]
    inner = [i for i, a in enumerate(names) if a in axes]
    n = math.prod(grid.shape[i] for i in inner)
    return [list(map(int, row)) for row in np.transpose(grid, rest + inner).reshape(-1, n)]


class ProcessMesh(ShardMesh):
    """Named axes over the ranks of the default process group (which
    :func:`init_group` started): position ``r`` is rank ``r``, row-major
    over ``axis_names``; ``devices`` lists every rank's device, ``device``
    is this rank's. Several meshes may share one group; every rank must
    build them in the same order (each makes its sub-groups)."""

    def __init__(self, shape, axis_names=("data",), *, device, timeout_s: float = 300.0):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: no process group; call init_group first")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = _rank_device(device, self.rank)
        self.backend = dist.get_backend()
        names = [None] * self.world
        dist.all_gather_object(names, str(self.device))
        super().__init__(names, shape=shape, axis_names=axis_names)
        extents = tuple(self.shape.values())
        self.coords = {a: int(c) for a, c in zip(self.axis_names,
                                                  np.unravel_index(self.rank, extents))}
        self.host_staged_bytes = 0
        self._groups = {}
        grid = np.arange(self.world).reshape(extents)
        timeout = datetime.timedelta(seconds=timeout_s)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                size = math.prod(self.shape[a] for a in axes)
                if size == 1:
                    continue  # a collective over one rank is no collective
                for ranks in _groups_over(grid, self.axis_names, axes):
                    g = (dist.group.WORLD if size == self.world
                         else dist.new_group(ranks, timeout=timeout))
                    if self.rank in ranks:
                        self._groups[axes] = g

    def axes_of(self, axes) -> tuple:
        """``axes`` in mesh order, those of extent 1 dropped."""
        want = set(axes)
        unknown = want - set(self.axis_names)
        if unknown:
            raise ValueError(f"ProcessMesh: no axis {sorted(unknown)} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in want and self.shape[a] > 1)

    def group(self, axes):
        """The sub-group of the ranks that differ from this one only on
        ``axes``; None when it holds this rank alone."""
        return self._groups.get(self.axes_of(axes))

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes_of(axes))

    def _moved(self, *ts):
        """Count the bytes of the CUDA tensors handed to gloo: its transport
        is TCP, so each goes through host memory (its CUDA collectives copy
        them to pinned host buffers and back)."""
        if self.backend == "gloo":
            self.host_staged_bytes += sum(t.numel() * t.element_size() for t in ts if t.is_cuda)

    def all_reduce(self, t, axes, op: str = "sum"):
        """``t`` reduced in place (``'sum'`` or ``'max'``) over ``axes``."""
        g = self.group(axes)
        if g is not None:
            dist.all_reduce(t, _OPS[op], group=g)
            self._moved(t, t)
        return t

    def all_gather(self, x, axes):
        """Every rank's ``x`` over ``axes``, concatenated flat in rank order."""
        g, n = self.group(axes), self.size(axes)
        x = x.contiguous().reshape(-1)
        if g is None:
            return x
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=g)
        self._moved(x, out)
        return out

    def reduce_scatter(self, x, axes):
        """``x`` (flat, ``n`` equal parts in rank order over ``axes``) summed
        over ``axes``; this rank keeps its part."""
        g, n = self.group(axes), self.size(axes)
        x = x.contiguous().reshape(-1)
        if g is None:
            return x
        out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=g)
        self._moved(x, out)
        return out

    def gather_first(self, x, axes):
        """Every rank's ``x`` over ``axes``, concatenated flat in rank order,
        on the first rank of the sub-group (None on the others)."""
        g, n = self.group(axes), self.size(axes)
        x = x.contiguous().reshape(-1)
        if g is None:
            return x
        first = min(dist.get_process_group_ranks(g))
        parts = [torch.empty_like(x) for _ in range(n)] if self.rank == first else None
        dist.gather(x, parts, dst=first, group=g)
        self._moved(x, *(parts or []))
        return None if parts is None else torch.cat(parts)

    def barrier(self):
        dist.barrier()

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


class Blocks:
    """An array of ``shape`` laid out on a :class:`ProcessMesh` by ``spec``
    (one entry per dimension: None, an axis or a tuple of axes): each rank
    holds one block, as a ``NamedSharding`` places it. Along a dimension the
    block index is the rank's coordinate over the entry's axes, row-major in
    the entry's order; the array is whole on the ranks that differ only on
    the axes the spec does not name."""

    def __init__(self, mesh: ProcessMesh, spec, shape):
        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(int(d) for d in shape)
        if len(self.spec) != len(self.shape):
            raise ValueError(f"Blocks: spec {self.spec} for shape {self.shape}")
        used = [a for e in self.spec for a in spec_axes(e)]
        self.axes = mesh.axes_of(used)  # the gather's sub-group
        self.replicated = tuple(a for a in mesh.axis_names if a not in used)
        self.block_shape = tuple(d // math.prod(mesh.shape[a] for a in spec_axes(e))
                                 for d, e in zip(self.shape, self.spec))

    def __getitem__(self, i):
        """One layer of a stacked array (its leading dimension unsharded)."""
        if self.spec[0] is not None:
            raise ValueError(f"Blocks: the stacked dimension is sharded ({self.spec})")
        return Blocks(self.mesh, self.spec[1:], self.shape[1:])

    def index(self):
        """This rank's block as slices of the whole array."""
        coords = self.mesh.coords
        out = []
        for blk, e in zip(self.block_shape, self.spec):
            c = 0
            for a in spec_axes(e):
                c = c * self.mesh.shape[a] + coords[a]
            out.append(slice(c * blk, (c + 1) * blk))
        return tuple(out)

    def owner(self) -> bool:
        """Whether this rank holds the first copy of its block: coordinate 0
        on every axis the spec does not name."""
        return all(self.mesh.coords[a] == 0 for a in self.replicated)

    def take(self, full):
        """This rank's block of the whole array ``full``, a copy of its own."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"Blocks: array of shape {tuple(full.shape)}, layout of {self.shape}")
        return full[self.index()].clone(memory_format=torch.contiguous_format)

    def _split(self):
        """(the whole array's shape split into [its axes' extents…, block]
        per dimension, the permutation from [gather axes…, block dims…] to
        that split)."""
        split, order = [], []
        for d, e in enumerate(self.spec):
            for a in spec_axes(e):
                if a in self.axes:
                    order.append(self.axes.index(a))
                    split.append(self.mesh.shape[a])
            order.append(len(self.axes) + d)
            split.append(self.block_shape[d])
        return split, order

    def _assemble(self, buf):
        """The whole array from the blocks in ``buf``, flat in rank order."""
        ext = [self.mesh.shape[a] for a in self.axes]
        _, order = self._split()
        return buf.view(*ext, *self.block_shape).permute(order).reshape(self.shape)

    def gather(self, block):
        """The whole array from every rank's ``block`` (an all-gather over
        the spec's axes; no gradient)."""
        if not self.axes:
            return block
        return self._assemble(self.mesh.all_gather(block, self.axes))

    def gather_first(self, block):
        """The whole array on the first rank of the spec's sub-group, None
        on the others."""
        if not self.axes:
            return block
        buf = self.mesh.gather_first(block, self.axes)
        return None if buf is None else self._assemble(buf)

    def reduce_scatter(self, full):
        """This rank's block of ``full`` summed over the spec's axes."""
        if not self.axes:
            return full
        split, order = self._split()
        inv = [order.index(i) for i in range(len(order))]
        parts = full.reshape(split).permute(inv)
        return self.mesh.reduce_scatter(parts, self.axes).view(self.block_shape)

    def __repr__(self):
        return f"Blocks(spec={self.spec}, shape={self.shape}, block={self.block_shape})"


class _Gather(torch.autograd.Function):
    """Block → whole array; the backward reduce-scatters the gradient (a
    sum over the spec's axes) back onto the block."""

    @staticmethod
    def forward(ctx, block, blocks):
        ctx.blocks = blocks
        return blocks.gather(block)

    @staticmethod
    def backward(ctx, grad):
        return ctx.blocks.reduce_scatter(grad), None


def gather_leaf(block, blocks: Blocks):
    """The whole array of this rank's ``block``, differentiable: the
    gradient of the whole array comes back as its block's share, summed over
    the ranks the block was gathered from. ``block`` itself when the spec
    names no axis of extent > 1."""
    return _Gather.apply(block, blocks) if blocks.axes else block


def _tree_map(fn, tree, *rest):
    # imported here and below: the train package imports this module
    from repro_torch.train.optimizer import tree_map

    return tree_map(fn, tree, *rest)


def param_blocks(cfg, mesh: ProcessMesh, rules):
    """The :class:`Blocks` of every parameter of ``cfg`` under ``rules``
    (a tree shaped like the parameters; from ``registry.abstract_params``,
    nothing allocated)."""
    from repro_torch.models.registry import abstract_params

    params, axes = abstract_params(cfg)
    return _tree_map(lambda p, ax: Blocks(mesh, logical_spec(tuple(p.shape), ax, mesh, rules),
                                          p.shape), params, axes)


def state_blocks(pblocks):
    """``{"params", "opt"}`` blocks of the training state: AdamW's ``mu``,
    ``nu`` and ``master`` in the parameters' blocks, its step counter whole."""
    from repro_torch.train.optimizer import AdamWState, tree_leaves

    mesh = tree_leaves(pblocks)[0].mesh
    return {"params": pblocks,
            "opt": AdamWState(step=Blocks(mesh, (), ()), mu=pblocks, nu=pblocks,
                              master=pblocks)}


def take_blocks(tree, blocks):
    """This rank's block of every whole leaf of ``tree``."""
    return _tree_map(lambda t, b: b.take(t), tree, blocks)


def gather_tree(tree, blocks):
    """Every leaf of ``tree`` (this rank's blocks) whole, on every rank."""
    return _tree_map(lambda t, b: b.gather(t), tree, blocks)


def tree_nbytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def free_address(host: str = "127.0.0.1") -> str:
    """``host:port`` with a port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def _run_rank(fn, rank, world, address, args, results):
    try:
        out = fn(rank, world, address, *args)
    except BaseException:  # noqa: BLE001 — reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args=(), *, timeout_s: float = 600.0,
                address: str | None = None):
    """Run ``fn(rank, world, address, *args)`` in ``world`` new processes
    (``spawn``; ``fn`` importable by name) and return their results in rank
    order. ``fn`` joins the group itself (:func:`init_group` at
    ``address``, by default a free port of this host). If a rank raises or
    dies, or the ranks are not all done after ``timeout_s``, every rank is
    stopped and this raises."""
    ctx = multiprocessing.get_context("spawn")
    address = address or free_address()
    results = ctx.Queue()
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world, address, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_ranks: {world - len(out)} of {world} ranks not done "
                                   f"after {timeout_s} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                if dead:
                    raise RuntimeError(f"spawn_ranks: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before it returned")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
