"""How ``correct`` is decided: the program's answers from the timed window
against the plain reference (``reference/tnkde_ref.py``).

The traffic driver keeps, for every answered query or request, its window
centres and the heat of a fixed set of lixels drawn from the seed before
the window opens. Once the window has closed and the program is freed, a
sample of the answers drawn from the seed is recomputed by the reference at
those lixels, and the number compared is the worst relative gap:

    rel_err = max over checked answers of
              max |F_program - F_reference| / max |F_reference|

taken over each answer's sampled lixels and all its windows. An answer
with a missing row, a wrong shape or a non-finite value reads as infinite.
"""
from __future__ import annotations

import numpy as np

from ..reference.tnkde_ref import exact_heat

__all__ = ["sample_lixels", "Answers", "compare"]


def sample_lixels(n_lixels: int, k: int, rng) -> np.ndarray:
    k = min(int(k), int(n_lixels))
    return np.sort(rng.choice(n_lixels, size=k, replace=False))


class Answers:
    """Answers kept from the window: centres and the sampled lixels' heat."""

    def __init__(self, lixels: np.ndarray, n_lixels: int):
        self.lixels = lixels
        self.n_lixels = n_lixels
        self.items = {}  # id -> (ts, heat [len(ts), k] or None when malformed)

    def keep(self, key, ts, heat) -> None:
        heat = np.asarray(heat)
        ok = heat.ndim == 2 and heat.shape == (len(ts), self.n_lixels)
        self.items[key] = (tuple(ts), heat[:, self.lixels].copy() if ok else None)


def compare(answers: Answers, picks, ds, cfg, b_t: float, device) -> float:
    """Worst relative gap over the picked answers (see the module doc)."""
    picks = list(picks)
    if not picks:
        return float("inf")
    ts = np.concatenate([np.asarray(answers.items[k][0]) for k in picks])
    ref = exact_heat(ds, g=cfg["g"], b_s=cfg["b_s"], b_t=b_t, lixels=answers.lixels,
                     ts=ts, spatial_kernel=cfg["spatial_kernel"],
                     temporal_kernel=cfg["temporal_kernel"], device=device)
    worst, col = 0.0, 0
    for k in picks:
        kts, heat = answers.items[k]
        want = ref[:, col:col + len(kts)].T  # [len(ts), k]
        col += len(kts)
        if heat is None or not np.isfinite(heat).all():
            return float("inf")
        scale = float(np.abs(want).max())
        if scale == 0.0:
            return float("inf")  # a sample with no mass cannot tell right from wrong
        worst = max(worst, float(np.abs(heat - want).max()) / scale)
    return worst
