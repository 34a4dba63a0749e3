"""Public wrappers of the hand-written kernels.

A wrapper takes its kernel's plain PyTorch version only for tensors that lie
on the CPU. For a CUDA tensor it launches the compiled kernel or raises:
there is no fallback and no switch that swaps the plain version in on the
card. Each wrapper counts its launches in a plain integer attribute
(``fused_walk.launches``, ``fused_leaf.launches``, ``tree_query.launches``,
``dyn_leaf_query.launches``, ``dyn_node_walk.launches``,
``minplus_matmul.launches``, ``flash_attention.launches``), incremented where
the kernel is launched and nowhere else. ``csrc/fused_walk.cu`` serves four
wrappers: ``fused_walk`` (the grouped JAX contract) and ``fused_walk_flat``
(the flat window table in place) count in ``fused_walk.launches``,
``dyn_node_walk`` and ``dyn_node_walk_flat`` in ``dyn_node_walk.launches``;
``csrc/fused_leaf.cu`` serves three: ``fused_leaf`` and ``fused_leaf_flat``
count in ``fused_leaf.launches``, ``dyn_leaf_query_flat`` (the kernel
executor's quantized flush) in ``dyn_leaf_query.launches``.
``dyn_leaf_query`` keeps the reference's grouped contract with materialised
query vectors on ``csrc/dyn_leaf_query.cu``. ``segment_add``
(``csrc/segment_add.cu``, counted in ``segment_add.launches``) is the
fixed-order scatter that ends every flush; it has no TPU counterpart.
``fold_node_tables`` (``csrc/fold_tables.cu``, counted in
``fold_node_tables.launches`` and per table dtype) is the packed RFS
executors' window-table fold, one launch a fold; it has no TPU counterpart
either.

The flat walk and leaf wrappers take the window table in the storage dtype
of the engine's table codec — float64, float32 or bfloat16 for the walk
(:data:`WALK_DTYPES`), float64 or float32 for the leaf (:data:`LEAF_DTYPES`)
— and launch that dtype's instantiation of the kernel, which widens every
loaded value to float64; a narrow table is never widened to reach the
float64 kernel. Those four wrappers' counts (``fused_walk``,
``dyn_node_walk``, ``fused_leaf``, ``dyn_leaf_query``) are also kept per
table dtype in ``launches_by_dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from .dyn_query import dyn_leaf_query_library, dyn_leaf_query_ref, dyn_node_walk_ref, tree_offs
from .fused_walk import (
    MAX_LEVELS,
    FlatIndex,
    fused_leaf_flat_ref,
    fused_leaf_library,
    fused_leaf_ref,
    fused_walk_flat_ref,
    fused_walk_library,
    fused_walk_ref,
    leaf_index,
    walk_index,
)
from .fold_tables import fold_node_tables_ref, fold_tables_library
from .fold_tables import MAX_LEVELS as FOLD_MAX_LEVELS
from .flash_attention import HEAD_DIMS, LOG2E, check_seq_len, flash_attention_ref, flash_library
from .minplus import minplus_library, minplus_matmul_ref, minplus_vec
from .segment_add import (
    SegmentIndex,
    segment_add_args,
    segment_add_library,
    segment_add_ref,
    segment_index,
)
from .tree_query import tree_query_library, tree_query_ref

__all__ = ["FlatIndex", "dyn_leaf_query", "dyn_leaf_query_flat", "dyn_node_walk",
           "dyn_node_walk_flat", "flash_attention", "fold_node_tables", "fused_leaf",
           "fused_leaf_flat", "fused_walk", "fused_walk_flat", "leaf_index", "minplus_matmul",
           "segment_add", "segment_index", "tree_query", "walk_index"]

# the table dtypes each kernel source is instantiated for, by the suffix of
# its C entry (the walk and the fold: every fold dtype of the table codec;
# the leaf: the moment dtypes, float64 and float32)
WALK_DTYPES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
LEAF_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
TABLE_DTYPES = ("float64", "float32", "bfloat16")  # keys of launches_by_dtype

# the fused_leaf kernel holds the two [W, k_t] temporal vectors and two rows
# per warp in shared memory (csrc/fused_leaf.cu SMEM_MAX)
LEAF_SMEM_MAX = 227 * 1024
# the fused_walk kernel copies an edge's block of the flat table into shared
# memory when the block would take at most this many bytes in float64
# (walk_staged): on the card the staged form was the faster one for the f64
# RFS blocks of npad 32, 64 and 128 (20, 40 and 80 KB) and by far the slower
# one for the 163 KB block of npad 256 (the DRFS tree; PERF.md §6)
WALK_STAGE_MAX = 96 * 1024
# dynamic shared memory a fused_walk block may use (csrc/fused_walk.cu SMEM_CAP)
WALK_SMEM_CAP = 227 * 1024
# the tree_query kernel copies an edge's block of the flat forest into
# shared memory when it takes at most this many bytes (tree_staged)
TREE_STAGE_MAX = 64 * 1024


def walk_stage_bytes(npad: int, wc: int, itemsize: int = 8) -> int:
    """Shared memory of the fused_walk kernel's staged edge block: 2·npad − 1
    nodes of two rows of ``wc`` values of ``itemsize`` bytes, rounded up to
    16 bytes (csrc/fused_walk.cu ``stage_bytes``)."""
    return -(-(2 * int(npad) - 1) * 2 * int(wc) * int(itemsize) // 16) * 16


def walk_stageable(npad: int, wc: int, itemsize: int = 8) -> bool:
    """Whether the fused_walk kernel can stage the edge block at all: npad a
    power of two, and the block with one warp's f64 row and its 32 atoms'
    emit rows within WALK_SMEM_CAP (csrc/fused_walk.cu's launcher shrinks
    the block's threads to 32 before it gives up)."""
    npad = int(npad)
    if npad <= 0 or npad & (npad - 1):
        return False
    emit_rows = 32 * (2 * npad.bit_length() + 1) * 4
    return walk_stage_bytes(npad, wc, itemsize) + int(wc) * 8 + emit_rows <= WALK_SMEM_CAP


def walk_staged(npad: int, wc: int, itemsize: int = 8) -> bool:
    """Whether the fused_walk kernel stages an edge's block in shared memory
    (csrc/fused_walk.cu's ``STAGED`` form) by default: it can, and the block
    would take at most WALK_STAGE_MAX bytes in float64 — the npad classes a
    float64 table stages, whatever the table stores. A float32 or bfloat16
    block of npad 256 fits the same bytes, but on the card its staged form
    was slower for the DRFS complete tree (few atoms per group to repay the
    copy) while faster for the RFS packs (PERF.md §6)."""
    return walk_stageable(npad, wc, itemsize) and walk_stage_bytes(npad, wc) <= WALK_STAGE_MAX


def walk_form(npad: int, wc: int, data_ptr: int, staged=None, itemsize: int = 8) -> bool:
    """The form a fused_walk launch on a table at ``data_ptr`` (values of
    ``itemsize`` bytes) takes: ``staged`` None picks :func:`walk_staged` when
    the table is 16-byte aligned (the copy moves 16- or 8-byte pieces); a
    staged form forced on a table that cannot take it raises instead of
    running the other form."""
    aligned = int(data_ptr) % 16 == 0
    if staged is None:
        return aligned and walk_staged(npad, wc, itemsize)
    if staged and not (aligned and walk_stageable(npad, wc, itemsize)):
        raise ValueError(f"fused_walk: the staged form needs a 16-byte aligned table and an "
                         f"edge block that fits shared memory (npad {npad}, row width {wc}, "
                         f"{itemsize}-byte values)")
    return bool(staged)


def tree_staged(npad: int, k4: int) -> bool:
    """Whether the tree_query kernel stages an edge's block — npad.bit_length()
    levels of npad rows, a position and 4K = ``k4`` prefix values each, f64 —
    in shared memory (csrc/tree_query.cu's ``staged`` branch)."""
    return int(npad).bit_length() * int(npad) * (1 + int(k4)) * 8 <= TREE_STAGE_MAX


def _check(kernel, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the table on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _table_suffix(kernel, dtype, dtypes) -> str:
    """The suffix of the C entry for a table's storage dtype (``f64``,
    ``f32``, ``bf16``); a dtype the source is not instantiated for raises."""
    suffix = dtypes.get(dtype)
    if suffix is None:
        raise TypeError(f"{kernel}: the table must be one of "
                        f"{', '.join(str(d) for d in dtypes)}, got {dtype}")
    return suffix


def _count(wrapper, table):
    """One launch of ``wrapper``'s kernel on ``table``: the total count and
    the count for the table's dtype."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(table.dtype).removeprefix("torch.")] += 1


def _check_rows(kernel, table, index):
    """The one range check of a launch on a flat table, against the row
    count its index was checked for when the pack was built (no host sync)."""
    if index.rows > table.shape[0]:
        raise ValueError(f"{kernel}: the pack reads rows up to {index.rows}, but the table has "
                         f"{table.shape[0]}: lvl_base/edges out of range for this table")


def _walk_launch(kernel, table, lvl_base, edges, r_lo, r_hi, side, qs, out, *, nlev, npad,
                 blk_rows, staged):
    """Checks and launch of ``csrc/fused_walk.cu`` on the flat rows
    ``table [N2, W·2k_s]`` (float64, float32 or bfloat16: that dtype's
    instantiation): the shared body of every walk wrapper (each counts its
    own launches). ``out`` is [G, Q, W] float64 or a view of it with other
    strides."""
    if table.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {table.device}")
    if table.dim() != 2 or qs.dim() != 3 or lvl_base.dim() != 2:
        raise ValueError(f"{kernel}: the table must be [N2, W*2*k_s], qs [G, Q, k_s] and "
                         "lvl_base [levels, E]")
    N2, WC = table.shape
    G, Q, ks = (int(d) for d in qs.shape)
    if ks == 0 or WC % (2 * ks) or nlev > MAX_LEVELS or lvl_base.shape[0] < nlev:
        raise ValueError(
            f"{kernel}: row width {WC} is not W*2*k_s for k_s={ks}, or more than "
            f"{MAX_LEVELS} levels ({nlev}), or lvl_base has fewer than {nlev} rows"
        )
    W = WC // (2 * ks)
    dev = table.device
    suffix = _table_suffix(kernel, table.dtype, WALK_DTYPES)
    _check(kernel, "table", table, table.dtype, (N2, WC), dev)
    _check(kernel, "lvl_base", lvl_base, torch.int64, tuple(lvl_base.shape), dev)
    _check(kernel, "edges", edges, torch.int64, (G,), dev)
    _check(kernel, "qs", qs, torch.float64, (G, Q, ks), dev)
    for name, t in (("r_lo", r_lo), ("r_hi", r_hi), ("side", side)):
        _check(kernel, name, t, torch.int32, (G, Q), dev)
    if out.numel() == 0:
        return False  # nothing to launch
    fn = getattr(fused_walk_library(), f"fused_walk_{suffix}")
    so_g, so_q, so_w = out.stride()
    err = fn(
        table.data_ptr(), N2, lvl_base.data_ptr(), max(int(lvl_base.shape[1]), 1),
        edges.data_ptr(), r_lo.data_ptr(), r_hi.data_ptr(), side.data_ptr(), qs.data_ptr(),
        out.data_ptr(), so_g, so_q, so_w, G, Q, W, ks, nlev, npad, blk_rows, int(bool(staged)),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed (cudaError {err})")
    return True


def _walk_grouped(kernel, nodeval, r_lo, r_hi, side, qs, offs):
    """The grouped JAX contract on the flat kernel: group g's block is rows
    [g·R2, (g+1)·R2) of nodeval viewed flat, ``lvl_base[ℓ, g] = g·R2/2 +
    offs[ℓ]``, rows clamped to the block as the reference clamps them;
    out [G, W, Q]."""
    if nodeval.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {nodeval.device}")
    if nodeval.dim() != 3 or qs.dim() != 3:
        raise ValueError(f"{kernel}: nodeval must be [G, R2, W*2*k_s] and qs [G, Q, k_s]")
    G, R2, WC = (int(d) for d in nodeval.shape)
    Q, ks = int(qs.shape[1]), int(qs.shape[2])
    if R2 % 2 or R2 == 0 or ks == 0 or WC % (2 * ks):
        raise ValueError(f"{kernel}: nodeval must hold paired rows (R2={R2} even, > 0) of "
                         f"W*2*k_s values (row width {WC}, k_s={ks})")
    _check(kernel, "nodeval", nodeval, torch.float64, (G, R2, WC), nodeval.device)
    dev = nodeval.device
    out = torch.empty((G, WC // (2 * ks), Q), dtype=torch.float64, device=dev)
    lvl_base = (torch.arange(G, device=dev)[None] * (R2 // 2)
                + torch.tensor(offs, dtype=torch.int64, device=dev).reshape(-1, 1))
    launched = _walk_launch(kernel, nodeval.reshape(G * R2, WC), lvl_base,
                            torch.arange(G, device=dev), r_lo, r_hi, side, qs,
                            out.permute(0, 2, 1), nlev=len(offs), npad=0, blk_rows=R2,
                            staged=False)
    return out, launched


def _walk_flat(kernel, table, index, r_lo, r_hi, side, qs, staged=None):
    """A walk on the flat table in place: [G, Q, W], in the form
    :func:`walk_form` gives; chip_smoke.py forces either form to time both."""
    _check_rows(kernel, table, index)
    if table.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {table.device}")
    npad = int(index.span)
    G, Q, ks = (int(d) for d in qs.shape)
    WC = int(table.shape[1]) if table.dim() == 2 else 0
    W = WC // (2 * ks) if ks else 0
    staged = walk_form(npad, WC, table.data_ptr(), staged, table.element_size())
    out = torch.empty((G, Q, W), dtype=torch.float64, device=table.device)
    launched = _walk_launch(kernel, table, index.lvl_base, index.edges, r_lo, r_hi, side, qs,
                            out, nlev=npad.bit_length(), npad=npad, blk_rows=0, staged=staged)
    return out, launched


def fused_walk(nodeval, r_lo, r_hi, side, qs, *, offs) -> torch.Tensor:
    """Fused packed-plan walk over the grouped layout (the JAX contract):
    the whole canonical climb + window contraction in one launch (see
    fused_walk.py): [G, W, Q] float64, halves folded.

    ``nodeval [G, R2, W·2k_s]`` float64, ``r_lo/r_hi/side [G, Q]`` int32,
    ``qs [G, Q, k_s]`` float64, all contiguous and on one device; ``offs``
    the static per-level row offsets. Launches on the current stream and
    does not synchronise.
    """
    offs = tuple(int(o) for o in offs)
    if nodeval.device.type == "cpu":
        return fused_walk_ref(nodeval, r_lo, r_hi, side, qs, offs=offs)
    out, launched = _walk_grouped("fused_walk", nodeval, r_lo, r_hi, side, qs, offs)
    if launched:
        _count(fused_walk, nodeval)
    return out


fused_walk.launches = 0
fused_walk.launches_by_dtype = dict.fromkeys(TABLE_DTYPES, 0)


def fused_walk_flat(table, index: FlatIndex, r_lo, r_hi, side, qs) -> torch.Tensor:
    """Fused walk on the flat window table in place (the fused executor's
    flush, see fused_walk.py): [G, Q, W] float64, halves folded.

    ``table [N2, W·2k_s]`` float64, float32 or bfloat16 (``packed_node_tables``
    / ``dyn_node_tables`` in the codec's fold dtype, viewed as rows),
    ``index`` from :func:`walk_index` (range-checked when
    the pack was built; here only its row count against the table's),
    ``r_lo/r_hi/side [G, Q]`` int32, ``qs [G, Q, k_s]`` float64, all
    contiguous and on one device. Counts in ``fused_walk.launches``.
    Launches on the current stream and does not synchronise.
    """
    if table.device.type == "cpu":
        return fused_walk_flat_ref(table, index, r_lo, r_hi, side, qs)
    out, launched = _walk_flat("fused_walk", table, index, r_lo, r_hi, side, qs)
    if launched:
        _count(fused_walk, table)
    return out


def fused_leaf(lcum, leaf_lo, leaf_hi, side, qs, qtl, qtr) -> torch.Tensor:
    """Fused quantized DRFS tree phase over the grouped layout (the JAX
    contract): leaf-prefix difference + q_s ⊗ q_t window contraction in one
    launch (see fused_walk.py): [G, W, Q] float64, halves folded.

    ``lcum [G, R, W·2K]`` float64 with K = k_s·k_t, ``leaf_lo/leaf_hi/side
    [G, Q]`` int32, ``qs [G, Q, k_s]``, ``qtl/qtr [W, k_t]`` float64, all
    contiguous and on one device. Launches on the current stream and does
    not synchronise.
    """
    if lcum.device.type == "cpu":
        return fused_leaf_ref(lcum, leaf_lo, leaf_hi, side, qs, qtl, qtr)
    if lcum.device.type != "cuda":
        raise ValueError(f"fused_leaf: unsupported device {lcum.device}")
    if lcum.dim() != 3 or qs.dim() != 3 or qtl.dim() != 2:
        raise ValueError("fused_leaf: lcum must be [G, R, W*2*K], qs [G, Q, k_s], qtl [W, k_t]")
    G, R, WK = (int(d) for d in lcum.shape)
    if R == 0:
        raise ValueError("fused_leaf: lcum has no rows per group (R = 0)")
    _check("fused_leaf", "lcum", lcum, torch.float64, (G, R, WK), lcum.device)
    out = torch.empty((G, int(qtl.shape[0]), int(qs.shape[1])), dtype=torch.float64,
                      device=lcum.device)
    if _leaf_launch("fused_leaf", lcum.reshape(G * R, WK),
                              torch.arange(G, device=lcum.device), R, leaf_lo, leaf_hi, side,
                              qs, qtl, qtr, out.permute(0, 2, 1)):
        _count(fused_leaf, lcum)
    return out


fused_leaf.launches = 0
fused_leaf.launches_by_dtype = dict.fromkeys(TABLE_DTYPES, 0)


def _leaf_flat(kernel, lcum, index, leaf_lo, leaf_hi, side, qs, qtl, qtr):
    """A leaf phase on the flat leaf-prefix table in place: [G, Q, W]."""
    _check_rows(kernel, lcum, index)
    if lcum.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {lcum.device}")
    out = torch.empty((int(qs.shape[0]), int(qs.shape[1]), int(qtl.shape[0])),
                      dtype=torch.float64, device=lcum.device)
    launched = _leaf_launch(kernel, lcum, index.edges, (int(index.span) + 1) * 2, leaf_lo,
                            leaf_hi, side, qs, qtl, qtr, out)
    return out, launched


def fused_leaf_flat(lcum, index: FlatIndex, leaf_lo, leaf_hi, side, qs, qtl, qtr) -> torch.Tensor:
    """Fused quantized DRFS tree phase on the flat leaf-prefix table in place
    (the fused executor's flush, see fused_walk.py): [G, Q, W] float64.

    ``lcum [E·(nleaf+1)·2, W·2K]`` float64 or float32 (``dyn_window_tables``
    in the codec's moment dtype, viewed as rows), ``index`` from
    :func:`leaf_index`, the rest as
    :func:`fused_leaf`. Counts in ``fused_leaf.launches``. Launches on the
    current stream and does not synchronise.
    """
    if lcum.device.type == "cpu":
        return fused_leaf_flat_ref(lcum, index, leaf_lo, leaf_hi, side, qs, qtl, qtr)
    out, launched = _leaf_flat("fused_leaf", lcum, index, leaf_lo, leaf_hi, side, qs, qtl, qtr)
    if launched:
        _count(fused_leaf, lcum)
    return out


def _leaf_launch(kernel, lcum, edges, R, leaf_lo, leaf_hi, side, qs, qtl, qtr, out):
    """Checks and launch of ``csrc/fused_leaf.cu`` on the flat rows
    ``lcum [N, W·2K]`` (float64 or float32: that dtype's instantiation), R
    rows per edge; ``out`` [G, Q, W] float64 or a view of it with other
    strides. Returns whether it launched."""
    if lcum.dim() != 2 or qs.dim() != 3 or qtl.dim() != 2:
        raise ValueError(f"{kernel}: lcum must be [N, W*2*K], qs [G, Q, k_s], qtl [W, k_t]")
    N, WK = (int(d) for d in lcum.shape)
    G, Q, ks = (int(d) for d in qs.shape)
    W, kt = int(qtl.shape[0]), int(qtl.shape[1])
    smem = (2 * W * kt + 2 * WK) * 8  # the temporal vectors and one warp's two rows
    if ks == 0 or kt == 0 or WK != W * 2 * ks * kt or smem > LEAF_SMEM_MAX:
        raise ValueError(
            f"{kernel}: row width {WK} is not W*2*k_s*k_t for W={W}, k_s={ks}, "
            f"k_t={kt}, or the [W, k_t] vectors and two rows exceed {LEAF_SMEM_MAX} bytes"
        )
    dev = lcum.device
    suffix = _table_suffix(kernel, lcum.dtype, LEAF_DTYPES)
    _check(kernel, "lcum", lcum, lcum.dtype, (N, WK), dev)
    _check(kernel, "edges", edges, torch.int64, (G,), dev)
    _check(kernel, "qs", qs, torch.float64, (G, Q, ks), dev)
    for name, t in (("qtl", qtl), ("qtr", qtr)):
        _check(kernel, name, t, torch.float64, (W, kt), dev)
    for name, t in (("leaf_lo", leaf_lo), ("leaf_hi", leaf_hi), ("side", side)):
        _check(kernel, name, t, torch.int32, (G, Q), dev)
    if out.numel() == 0:
        return False  # nothing to launch
    fn = getattr(fused_leaf_library(), f"fused_leaf_{suffix}")
    so_g, so_q, so_w = out.stride()
    err = fn(
        lcum.data_ptr(), N, edges.data_ptr(), R, leaf_lo.data_ptr(), leaf_hi.data_ptr(),
        side.data_ptr(), qs.data_ptr(), qtl.data_ptr(), qtr.data_ptr(), out.data_ptr(),
        so_g, so_q, so_w, G, Q, W, ks, kt, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed (cudaError {err})")
    return True


def tree_query(pos_flat, cum_flat, base, r_lo, r_hi, pos_hi, pos_lo1, lo1_right, pos_lo2, qs,
               qt, side, half, *, npad: int) -> torch.Tensor:
    """Merge-tree range query over the flat forest (see tree_query.py):
    [G, Q, Wh] float64.

    ``pos_flat [T]`` and ``cum_flat [T, 4·k_s·k_t]`` (the forest's tables),
    ``pos_hi/pos_lo1/pos_lo2 [G, Q]``, ``qs [G, Q, k_s]`` and
    ``qt [Wh, k_t]`` float64; ``base [G]`` int64 (each group's first row,
    ``npad.bit_length()`` levels of ``npad`` rows from there);
    ``r_lo/r_hi [G, Wh]``, ``lo1_right/side [G, Q]`` and ``half [Wh]``
    int32; all contiguous and on one device. Launches on the current stream
    and does not synchronise.
    """
    if pos_flat.device.type == "cpu":
        return tree_query_ref(pos_flat, cum_flat, base, r_lo, r_hi, pos_hi, pos_lo1, lo1_right,
                              pos_lo2, qs, qt, side, half, npad=npad)
    if pos_flat.device.type != "cuda":
        raise ValueError(f"tree_query: unsupported device {pos_flat.device}")
    if pos_flat.dim() != 1 or cum_flat.dim() != 2 or r_lo.dim() != 2 or qs.dim() != 3 \
            or qt.dim() != 2:
        raise ValueError("tree_query: pos_flat must be [T], cum_flat [T, 4K], r_lo [G, Wh], "
                         "qs [G, Q, k_s], qt [Wh, k_t]")
    T = int(pos_flat.shape[0])
    G, Wh = int(r_lo.shape[0]), int(r_lo.shape[1])
    Q, ks, kt = int(qs.shape[1]), int(qs.shape[2]), int(qt.shape[1])
    npad = int(npad)
    lvl = npad.bit_length()
    if ks == 0 or kt == 0 or lvl > 31 or npad & (npad - 1):
        raise ValueError(f"tree_query: k_s={ks}, k_t={kt}, npad={npad} not served "
                         "(npad is a power of two or 0)")
    dev = pos_flat.device
    _check("tree_query", "pos_flat", pos_flat, torch.float64, (T,), dev)
    _check("tree_query", "cum_flat", cum_flat, torch.float64, (T, 4 * ks * kt), dev)
    _check("tree_query", "base", base, torch.int64, (G,), dev)
    for name, t in (("r_lo", r_lo), ("r_hi", r_hi)):
        _check("tree_query", name, t, torch.int32, (G, Wh), dev)
    for name, t in (("pos_hi", pos_hi), ("pos_lo1", pos_lo1), ("pos_lo2", pos_lo2)):
        _check("tree_query", name, t, torch.float64, (G, Q), dev)
    for name, t in (("lo1_right", lo1_right), ("side", side)):
        _check("tree_query", name, t, torch.int32, (G, Q), dev)
    _check("tree_query", "qs", qs, torch.float64, (G, Q, ks), dev)
    _check("tree_query", "qt", qt, torch.float64, (Wh, kt), dev)
    _check("tree_query", "half", half, torch.int32, (Wh,), dev)
    out = torch.empty((G, Q, Wh), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = tree_query_library()
    err = lib.tree_query_f64(
        pos_flat.data_ptr(), cum_flat.data_ptr(), base.data_ptr(), r_lo.data_ptr(),
        r_hi.data_ptr(), pos_hi.data_ptr(), pos_lo1.data_ptr(), lo1_right.data_ptr(),
        pos_lo2.data_ptr(), qs.data_ptr(), qt.data_ptr(), side.data_ptr(), half.data_ptr(),
        out.data_ptr(), G, npad, Q, Wh, ks, kt, int(tree_staged(npad, 4 * ks * kt)),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_query: kernel launch failed (cudaError {err})")
    tree_query.launches += 1
    return out


tree_query.launches = 0


def dyn_leaf_query(tab, leaf_lo, leaf_hi, side, qv_l, qv_r) -> torch.Tensor:
    """Quantized DRFS tree phase with materialised query vectors (see
    dyn_query.py): [G, W, Q] float64, halves folded.

    ``tab [G, R, W·2K]`` and ``qv_l/qv_r [G, W, Q, K]`` float64,
    ``leaf_lo/leaf_hi/side [G, Q]`` int32, all contiguous and on one device.
    Launches on the current stream and does not synchronise.
    """
    if tab.device.type == "cpu":
        return dyn_leaf_query_ref(tab, leaf_lo, leaf_hi, side, qv_l, qv_r)
    if tab.device.type != "cuda":
        raise ValueError(f"dyn_leaf_query: unsupported device {tab.device}")
    if tab.dim() != 3 or qv_l.dim() != 4:
        raise ValueError("dyn_leaf_query: tab must be [G, R, W*2*K] and qv_l [G, W, Q, K]")
    G, R, WK = tab.shape
    W, Q, K = int(qv_l.shape[1]), int(qv_l.shape[2]), int(qv_l.shape[3])
    if K == 0 or WK != W * 2 * K:
        raise ValueError(f"dyn_leaf_query: row width {WK} is not W*2*K for W={W}, K={K}")
    dev = tab.device
    _check("dyn_leaf_query", "tab", tab, torch.float64, (G, R, WK), dev)
    for name, t in (("qv_l", qv_l), ("qv_r", qv_r)):
        _check("dyn_leaf_query", name, t, torch.float64, (G, W, Q, K), dev)
    for name, t in (("leaf_lo", leaf_lo), ("leaf_hi", leaf_hi), ("side", side)):
        _check("dyn_leaf_query", name, t, torch.int32, (G, Q), dev)
    out = torch.empty((G, W, Q), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = dyn_leaf_query_library()
    err = lib.dyn_leaf_query_f64(
        tab.data_ptr(), leaf_lo.data_ptr(), leaf_hi.data_ptr(), side.data_ptr(),
        qv_l.data_ptr(), qv_r.data_ptr(), out.data_ptr(), G, R, Q, W, K,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dyn_leaf_query: kernel launch failed (cudaError {err})")
    _count(dyn_leaf_query, tab)
    return out


dyn_leaf_query.launches = 0
dyn_leaf_query.launches_by_dtype = dict.fromkeys(TABLE_DTYPES, 0)


def dyn_leaf_query_flat(lcum, index: FlatIndex, leaf_lo, leaf_hi, side, qs, qtl,
                        qtr) -> torch.Tensor:
    """Quantized DRFS tree phase of the kernel executor on the flat
    leaf-prefix table in place: the function of :func:`dyn_leaf_query` with
    its query vectors ``qv_l/qv_r = q_s ⊗ qtl / q_s ⊗ qtr`` (s-major) built
    in the kernel, not materialised. The inputs of :func:`fused_leaf_flat`;
    launches ``csrc/fused_leaf.cu`` and counts in
    ``dyn_leaf_query.launches``. [G, Q, W] float64.
    """
    if lcum.device.type == "cpu":
        return fused_leaf_flat_ref(lcum, index, leaf_lo, leaf_hi, side, qs, qtl, qtr)
    out, launched = _leaf_flat("dyn_leaf_query", lcum, index, leaf_lo, leaf_hi, side, qs, qtl,
                               qtr)
    if launched:
        _count(dyn_leaf_query, lcum)
    return out


def dyn_node_walk(nodeval, r_lo, r_hi, side, qs, *, hq) -> torch.Tensor:
    """Exact-mode DRFS tree phase over the complete tree of height ``hq``
    (see dyn_query.py): [G, W, Q] float64, halves folded. The inputs of
    :func:`fused_walk`; launches ``csrc/fused_walk.cu`` with
    ``offs = tree_offs(hq)`` and counts in ``dyn_node_walk.launches``.
    """
    if nodeval.device.type == "cpu":
        return dyn_node_walk_ref(nodeval, r_lo, r_hi, side, qs, hq=int(hq))
    out, launched = _walk_grouped("dyn_node_walk", nodeval, r_lo, r_hi, side, qs,
                                  tree_offs(int(hq)))
    if launched:
        _count(dyn_node_walk, nodeval)
    return out


dyn_node_walk.launches = 0
dyn_node_walk.launches_by_dtype = dict.fromkeys(TABLE_DTYPES, 0)


def dyn_node_walk_flat(table, index: FlatIndex, r_lo, r_hi, side, qs) -> torch.Tensor:
    """Exact-mode DRFS tree phase of the kernel executor on the flat
    ``dyn_node_tables`` in place: :func:`fused_walk_flat` with ``index`` from
    ``walk_index(dyn_node_base(E, hq), edges, 2**hq)``, counted in
    ``dyn_node_walk.launches``. [G, Q, W] float64."""
    if table.device.type == "cpu":
        return fused_walk_flat_ref(table, index, r_lo, r_hi, side, qs)
    out, launched = _walk_flat("dyn_node_walk", table, index, r_lo, r_hi, side, qs)
    if launched:
        _count(dyn_node_walk, table)
    return out


def minplus_matmul(a, b, *, out=None) -> torch.Tensor:
    """(min, +) matrix product ``out[i, j] = min_k a[i, k] + b[k, j]`` (see
    minplus.py): ``a [M, K]``, ``b [K, N]``, both float32 or both float64,
    contiguous and on one device; ``[M, N]`` of their dtype, written into
    ``out`` when given (contiguous, not overlapping ``a`` or ``b``). Inputs
    are distances: finite or +inf. Launches on the current stream and does
    not synchronise.
    """
    if a.device.type == "cpu":
        return minplus_matmul_ref(a, b, out=out)
    if a.device.type != "cuda":
        raise ValueError(f"minplus_matmul: unsupported device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus_matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         "are not [M, K] and [K, N]")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"minplus_matmul: dtype must be float32 or float64, got {a.dtype}")
    M, K = a.shape
    N = int(b.shape[1])
    dev = a.device
    _check("minplus_matmul", "a", a, a.dtype, (M, K), dev)
    _check("minplus_matmul", "b", b, a.dtype, (K, N), dev)
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=dev)
    else:
        _check("minplus_matmul", "out", out, a.dtype, (M, N), dev)
    if out.numel() == 0:
        return out  # nothing to launch
    if K == 0:
        return out.fill_(float("inf"))  # the minimum of nothing
    lib = minplus_library()
    fn = lib.minplus_f64 if a.dtype == torch.float64 else lib.minplus_f32
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(minplus_vec(a, b)),
             _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus_matmul: kernel launch failed (cudaError {err})")
    minplus_matmul.launches += 1
    return out


minplus_matmul.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Forward online-softmax attention (see flash_attention.py):
    ``q [B, H, S, D]``, ``k/v [B, Hkv, S, D]``, one dtype (bfloat16: the
    tensor-core kernel; float32: the CUDA-core kernel), on one device, each
    with its last dimension contiguous (any batch, head and sequence strides
    — for bf16 multiples of 8 elements: a ``[B, S, H, D]`` tensor transposed
    is taken as it is). Returns ``[B, H, S, D]`` of ``q.dtype``, laid out in
    memory as ``[B, S, H, D]`` (so ``.transpose(1, 2)`` of it is
    contiguous). Launches on the current stream and does not synchronise.

    Forward only, on both devices: under autograd (grad enabled and any of
    q, k, v requiring grad) it raises rather than hand back an output with
    no gradient — the reference's Pallas kernel has no backward either.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (nor has the reference's Pallas kernel): "
            "train with attn_impl='dense' or 'blocked' ('auto' picks one), or call it under "
            "torch.no_grad()")
    B, H, S, D = q.shape
    check_seq_len(S)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype must be float32 or bfloat16, got {q.dtype}")
    Hkv = int(k.shape[1])
    if D not in HEAD_DIMS or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: D={D} not in {HEAD_DIMS} or H={H} not a multiple "
                         f"of Hkv={Hkv}")
    dev = q.device
    for name, t, shape in (("q", q, (B, H, S, D)), ("k", k, (B, Hkv, S, D)),
                           ("v", v, (B, Hkv, S, D))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must have its last dimension contiguous")
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the TMA maps of the tensor-core kernel
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(t.stride(i) % 8 for i in (0, 1, 2)) or t.data_ptr() % 16:
                raise ValueError(f"flash_attention: bf16 {name} needs batch, head and sequence "
                                 "strides of multiples of 8 elements and a 16-byte aligned base")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out  # nothing to launch
    scale = float(D ** -0.5) if scale is None else float(scale)
    strides = (ctypes.c_longlong * 12)(*(int(t.stride(i)) for t in (q, k, v, out)
                                         for i in (0, 1, 2)))
    lib = flash_library()
    fn = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, S, D, strides,
             scale * LOG2E if bf16 else scale, int(bool(causal)), _device_index(dev),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def segment_add(heat, src, index: SegmentIndex, *, halves: bool = False) -> torch.Tensor:
    """Fixed-order scatter of one pack's rows onto the heatmap, in place (see
    segment_add.py): ``heat[lixel[u], w] += Σ x(rows[i], w)`` over each
    segment of ``index`` in plan order; returns ``heat``.

    ``heat [L, W]`` float64 contiguous, any W; ``src [N, C]`` float64 with
    any strides (C = W, or 2W half-window columns folded pairwise with
    ``halves``); ``index`` from :func:`segment_index`, on the same device
    (its blocks and device pointers are built with it, not re-read here).
    On the card: one launch of ``index.n_blocks`` blocks, each staging its
    segments' rows in shared memory a tile at a time and adding them in
    order, one thread per (segment, column). Counts in
    ``segment_add.launches``. Launches on the current stream, does not
    synchronise and allocates nothing.
    """
    if heat.device.type == "cpu":
        return segment_add_ref(heat, src, index, halves=halves)
    if heat.device.type != "cuda":
        raise ValueError(f"segment_add: unsupported device {heat.device}")
    if heat.dim() != 2 or src.dim() != 2:
        raise ValueError("segment_add: heat must be [L, W] and src [N, C]")
    L, W = (int(d) for d in heat.shape)
    N, C = (int(d) for d in src.shape)
    if C != (2 * W if halves else W):
        raise ValueError(f"segment_add: src has {C} columns for {W} windows"
                         + (" (half-window pairs)" if halves else ""))
    if index.src_rows > N:
        raise ValueError(f"segment_add: the index reads source rows up to {index.src_rows}, "
                         f"but src has {N}")
    dev = heat.device
    _check("segment_add", "heat", heat, torch.float64, (L, W), dev)
    if src.device != dev or src.dtype != torch.float64:
        raise ValueError(f"segment_add: src must be float64 on {dev}, got {src.dtype} on "
                         f"{src.device}")
    U = index.n_segs
    _check("segment_add", "rows", index.rows, torch.int64, (index.n_rows,), dev)
    _check("segment_add", "seg_ptr", index.seg_ptr, torch.int64, (U + 1,), dev)
    _check("segment_add", "lixel", index.lixel, torch.int64, (U,), dev)
    if index.n_blocks == 0 or W == 0:
        return heat  # nothing to launch
    err = segment_add_library().segment_add_f64(
        *segment_add_args(heat, src, index, halves=halves), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segment_add: kernel launch failed (cudaError {err})")
    segment_add.launches += 1
    return heat


segment_add.launches = 0


def fold_node_tables(time_tab, cum_tab, starts, t_lo, t_hi, qt, *, lvl_ptr, steps, k_t,
                     out_dtype=None) -> torch.Tensor:
    """The packed RFS executors' window-table fold (see fold_tables.py):
    every node's q_t-folded paired window values, ``[R·2, W, 2k_s]`` in
    ``out_dtype`` (the table codec's fold dtype; float64 if None).

    ``time_tab [T]`` and ``cum_tab [T, 4, K]`` float64 (the packed forest's
    ``pm_time`` / ``pm_cum``, K = k_s·k_t), ``starts [R]`` int64 (every
    node's run start, level-major: level ℓ's nodes are
    ``starts[lvl_ptr[ℓ]:lvl_ptr[ℓ+1]]``, runs of 2^ℓ searched in
    ``steps[ℓ]`` trips; ``lvl_ptr`` and ``steps`` host ints),
    ``t_lo/t_hi [2W]`` and ``qt [2W, k_t]`` float64 (the paired
    half-window batch), all contiguous and on one device. On the card: one
    launch for every level, the table allocated once and written in place,
    counted in ``fold_node_tables.launches`` and per table dtype; launches
    on the current stream and does not synchronise.
    """
    kernel = "fold_node_tables"
    lvl_ptr = tuple(int(p) for p in lvl_ptr)
    steps = tuple(int(s) for s in steps)
    dev = time_tab.device
    if time_tab.dim() != 1 or cum_tab.dim() != 3 or qt.dim() != 2:
        raise ValueError(f"{kernel}: time_tab must be [T], cum_tab [T, 4, K] and qt [2W, k_t]")
    T, K = int(time_tab.shape[0]), int(cum_tab.shape[2])
    R, Wh = int(starts.shape[0]), int(t_lo.shape[0])
    nlev = len(lvl_ptr) - 1
    if k_t < 1 or K % k_t or Wh % 2 or T == 0:
        raise ValueError(f"{kernel}: K={K} is not k_s*k_t for k_t={k_t}, {Wh} half-windows "
                         f"are not paired, or the time table is empty")
    if not 1 <= nlev <= FOLD_MAX_LEVELS or lvl_ptr[0] != 0 or lvl_ptr[-1] != R \
            or any(b < a for a, b in zip(lvl_ptr, lvl_ptr[1:])) or len(steps) < nlev:
        raise ValueError(f"{kernel}: lvl_ptr {lvl_ptr} does not split {R} nodes into 1 to "
                         f"{FOLD_MAX_LEVELS} levels, or steps has fewer than {nlev} entries")
    out_dtype = torch.float64 if out_dtype is None else out_dtype
    suffix = _table_suffix(kernel, out_dtype, WALK_DTYPES)
    _check(kernel, "time_tab", time_tab, torch.float64, (T,), dev)
    _check(kernel, "cum_tab", cum_tab, torch.float64, (T, 4, K), dev)
    _check(kernel, "starts", starts, torch.int64, (R,), dev)
    _check(kernel, "t_lo", t_lo, torch.float64, (Wh,), dev)
    _check(kernel, "t_hi", t_hi, torch.float64, (Wh,), dev)
    _check(kernel, "qt", qt, torch.float64, (Wh, k_t), dev)
    if dev.type == "cpu":
        return fold_node_tables_ref(time_tab, cum_tab, starts, t_lo, t_hi, qt, lvl_ptr=lvl_ptr,
                                    steps=steps, k_t=k_t, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    W, ks = Wh // 2, K // k_t
    out = torch.empty((R * 2, W, 2 * ks), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = getattr(fold_tables_library(), f"fold_tables_{suffix}")
    err = fn(time_tab.data_ptr(), T, cum_tab.data_ptr(), starts.data_ptr(), R,
             (ctypes.c_longlong * len(lvl_ptr))(*lvl_ptr), (ctypes.c_int * nlev)(*steps[:nlev]),
             nlev, t_lo.data_ptr(), t_hi.data_ptr(), qt.data_ptr(), out.data_ptr(), W, ks, k_t,
             _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed (cudaError {err})")
    _count(fold_node_tables, out)
    return out


fold_node_tables.launches = 0
fold_node_tables.launches_by_dtype = dict.fromkeys(TABLE_DTYPES, 0)
