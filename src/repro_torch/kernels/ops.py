"""Public wrappers of the hand-written kernels.

A wrapper takes its kernel's plain PyTorch version only for tensors that lie
on the CPU. For a CUDA tensor it launches the compiled kernel or raises:
there is no fallback and no switch that swaps the plain version in on the
card. Each wrapper counts its launches in a plain integer attribute
(``fused_walk.launches``), incremented where the kernel is launched and
nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_walk import MAX_LEVELS, fused_walk_library, fused_walk_ref

__all__ = ["fused_walk"]


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"fused_walk: {name} is on {t.device}, nodeval on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_walk: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_walk: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_walk: {name} must be contiguous")


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
    _check("nodeval", nodeval, torch.float64, (G, R2, WC), dev)
    _check("qs", qs, torch.float64, (G, Q, ks), dev)
    for name, t in (("r_lo", r_lo), ("r_hi", r_hi), ("side", side)):
        _check(name, t, torch.int32, (G, Q), dev)
    out = torch.empty((G, W, Q), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = fused_walk_library()
    c_offs = (ctypes.c_int * max(len(offs), 1))(*offs)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.fused_walk_f64(
        nodeval.data_ptr(), r_lo.data_ptr(), r_hi.data_ptr(), side.data_ptr(),
        qs.data_ptr(), out.data_ptr(), G, R2, Q, W, ks, c_offs, len(offs),
        index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_walk: kernel launch failed (cudaError {err})")
    fused_walk.launches += 1
    return out


fused_walk.launches = 0
