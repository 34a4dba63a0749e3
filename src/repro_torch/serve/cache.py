"""Result cache for the serving subsystem (DESIGN.md §6).

One entry per evaluated (profile, epoch, window-center) triple, holding the
full [L] heatmap row. Keys embed the index epoch ``(revision,
pend_revision)``, so invalidation *is* the epoch mechanism the engines
already maintain: a mutation moves the epoch and every later request pins a
key no stale entry can match. Entries at older epochs are kept while
requests pinned to those epochs are still queued (an admitted-but-unflushed
request must be able to hit rows computed for its own snapshot) and are
dropped by ``prune_below`` once the scheduler no longer holds that epoch,
plus a plain LRU bound.

Full rows (every lixel) are cached rather than per-request lixel slices:
the engines' unit of work is the whole [W, L] heatmap, so a full row serves
every lixel subset for free — the request's lixel class is applied at
response assembly, never at evaluation.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["ResultCache"]

Key = Tuple[str, int, int, float]  # (profile, revision, pend_revision, center)


class ResultCache:
    def __init__(self, max_rows: int = 4096):
        self.max_rows = int(max_rows)
        self._rows: "OrderedDict[Key, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._rows)

    @staticmethod
    def key(profile: str, epoch: Tuple[int, int], center: float) -> Key:
        return (profile, int(epoch[0]), int(epoch[1]), float(center))

    def get(self, key: Key) -> Optional[np.ndarray]:
        row = self._rows.get(key)
        if row is None:
            self.misses += 1
            return None
        self._rows.move_to_end(key)
        self.hits += 1
        return row

    def put(self, key: Key, row: np.ndarray) -> None:
        self._rows[key] = row
        self._rows.move_to_end(key)
        while len(self._rows) > self.max_rows:
            self._rows.popitem(last=False)

    def prune_below(self, profile: str, epoch: Tuple[int, int]) -> int:
        """Drop entries of ``profile`` strictly older than ``epoch``.

        Called with the oldest epoch still pinned by a queued request, so
        rows a pending micro-batch could still hit are never evicted early.
        Returns the number of rows dropped.
        """
        stale = [
            k for k in self._rows
            if k[0] == profile and (k[1], k[2]) < (int(epoch[0]), int(epoch[1]))
        ]
        for k in stale:
            del self._rows[k]
        return len(stale)
