"""Deterministic, resumable synthetic LM data pipeline
(``repro.data.synthetic``), its own NumPy copy: batch ``t`` is bit for bit
the reference's token stream for the same ``(seed, step, host_id,
n_hosts)``.

  * **statelessly seekable** — batch t is a pure function of (seed, step), so
    a restarted job resumes the exact token stream from the checkpointed
    step with no data-loader state files;
  * **shardable** — each host materialises only its slice of the global
    batch (host_id / n_hosts);
  * structured enough to train on: a Zipf unigram mix + a first-order Markov
    chain + copy motifs, so small models show a real falling loss curve.

The tokens are drawn on the host with NumPy and handed over as ``torch.long``
tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    markov_states: int = 64

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        rng = np.random.default_rng(self.seed)
        # fixed Markov backbone shared by all steps (part of the "dataset")
        s = self.markov_states
        self._trans = rng.dirichlet(np.full(s, 0.3), size=s)
        self._emit = np.minimum(
            (rng.zipf(1.3, size=(s, 8)) - 1) % self.vocab, self.vocab - 1
        )

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def tokens(self, step: int) -> np.ndarray:
        """This host's ``[local_batch, seq_len + 1]`` int64 token stream of
        ``step`` — a pure function of (seed, step, host)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.host_id
        )
        B, S = self.local_batch, self.seq_len
        state = rng.integers(0, self.markov_states, size=B)
        toks = np.empty((B, S + 1), np.int64)
        u = rng.random((B, S + 1))
        pick = rng.integers(0, 8, size=(B, S + 1))
        for t in range(S + 1):
            toks[:, t] = self._emit[state, pick[:, t]]
            cdf = np.cumsum(self._trans[state], axis=1)
            state = (cdf < u[:, t : t + 1]).sum(axis=1).clip(0, self.markov_states - 1)
        # sprinkle copy motifs (induction-head signal)
        n_copy = max(S // 64, 1)
        for b in range(B):
            for _ in range(n_copy):
                ln = int(rng.integers(4, 12))
                src = int(rng.integers(0, max(S - 2 * ln, 1)))
                dst = int(rng.integers(src + ln, max(S - ln, src + ln) + 1))
                dst = min(dst, S - ln)
                toks[b, dst : dst + ln] = toks[b, src : src + ln]
        return toks

    def batch(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        """``{"tokens", "labels"}`` ``[local_batch, seq_len]`` ``torch.long``
        on ``device``: the stream and the stream shifted by one token."""
        toks = torch.from_numpy(self.tokens(step))
        return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
