"""Public wrappers of the hand-written kernels.

A wrapper takes its kernel's plain PyTorch version only for tensors that lie
on the CPU. For a CUDA tensor it launches the compiled kernel or raises:
there is no fallback and no switch that swaps the plain version in on the
card. Each wrapper counts its launches in a plain integer attribute
(``fused_walk.launches``, ``fused_leaf.launches``), incremented where the
kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_walk import (
    MAX_LEVELS,
    fused_leaf_library,
    fused_leaf_ref,
    fused_walk_library,
    fused_walk_ref,
)

__all__ = ["fused_leaf", "fused_walk"]

# the fused_leaf kernel holds the two [W, k_t] temporal vectors in shared
# memory (csrc/fused_leaf.cu SMEM_MAX)
LEAF_SMEM_MAX = 48 * 1024


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


def fused_walk(nodeval, r_lo, r_hi, side, qs, *, offs) -> torch.Tensor:
    """Fused packed-plan walk: the whole canonical climb + window contraction
    in one launch (see fused_walk.py): [G, W, Q] float64, halves folded.

    ``nodeval [G, R2, W·2k_s]`` float64, ``r_lo/r_hi/side [G, Q]`` int32,
    ``qs [G, Q, k_s]`` float64, all contiguous and on one device; ``offs``
    the static per-level row offsets. Launches on the current stream and
    does not synchronise.
    """
    offs = tuple(int(o) for o in offs)
    if nodeval.device.type == "cpu":
        return fused_walk_ref(nodeval, r_lo, r_hi, side, qs, offs=offs)
    if nodeval.device.type != "cuda":
        raise ValueError(f"fused_walk: unsupported device {nodeval.device}")
    if nodeval.dim() != 3 or qs.dim() != 3:
        raise ValueError("fused_walk: nodeval must be [G, R2, W*2*k_s] and qs [G, Q, k_s]")
    G, R2, WC = nodeval.shape
    Q, ks = int(qs.shape[1]), int(qs.shape[2])
    if ks == 0 or WC % (2 * ks) or len(offs) > MAX_LEVELS:
        raise ValueError(
            f"fused_walk: row width {WC} is not W*2*k_s for k_s={ks}, "
            f"or more than {MAX_LEVELS} levels ({len(offs)})"
        )
    W = WC // (2 * ks)
    dev = nodeval.device
    _check("fused_walk", "nodeval", nodeval, torch.float64, (G, R2, WC), dev)
    _check("fused_walk", "qs", qs, torch.float64, (G, Q, ks), dev)
    for name, t in (("r_lo", r_lo), ("r_hi", r_hi), ("side", side)):
        _check("fused_walk", name, t, torch.int32, (G, Q), dev)
    out = torch.empty((G, W, Q), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = fused_walk_library()
    c_offs = (ctypes.c_int * max(len(offs), 1))(*offs)
    err = lib.fused_walk_f64(
        nodeval.data_ptr(), r_lo.data_ptr(), r_hi.data_ptr(), side.data_ptr(),
        qs.data_ptr(), out.data_ptr(), G, R2, Q, W, ks, c_offs, len(offs),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_walk: kernel launch failed (cudaError {err})")
    fused_walk.launches += 1
    return out


fused_walk.launches = 0


def fused_leaf(lcum, leaf_lo, leaf_hi, side, qs, qtl, qtr) -> torch.Tensor:
    """Fused quantized DRFS tree phase: leaf-prefix difference + q_s ⊗ q_t
    window contraction in one launch (see fused_walk.py): [G, W, Q] float64,
    halves folded.

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
    G, R, WK = lcum.shape
    Q, ks = int(qs.shape[1]), int(qs.shape[2])
    W, kt = int(qtl.shape[0]), int(qtl.shape[1])
    if ks == 0 or kt == 0 or WK != W * 2 * ks * kt or 2 * W * kt * 8 > LEAF_SMEM_MAX:
        raise ValueError(
            f"fused_leaf: row width {WK} is not W*2*k_s*k_t for W={W}, k_s={ks}, "
            f"k_t={kt}, or the [W, k_t] vectors exceed {LEAF_SMEM_MAX} bytes"
        )
    dev = lcum.device
    _check("fused_leaf", "lcum", lcum, torch.float64, (G, R, WK), dev)
    _check("fused_leaf", "qs", qs, torch.float64, (G, Q, ks), dev)
    for name, t in (("qtl", qtl), ("qtr", qtr)):
        _check("fused_leaf", name, t, torch.float64, (W, kt), dev)
    for name, t in (("leaf_lo", leaf_lo), ("leaf_hi", leaf_hi), ("side", side)):
        _check("fused_leaf", name, t, torch.int32, (G, Q), dev)
    out = torch.empty((G, W, Q), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = fused_leaf_library()
    err = lib.fused_leaf_f64(
        lcum.data_ptr(), leaf_lo.data_ptr(), leaf_hi.data_ptr(), side.data_ptr(),
        qs.data_ptr(), qtl.data_ptr(), qtr.data_ptr(), out.data_ptr(),
        G, R, Q, W, ks, kt, _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_leaf: kernel launch failed (cudaError {err})")
    fused_leaf.launches += 1
    return out


fused_leaf.launches = 0
