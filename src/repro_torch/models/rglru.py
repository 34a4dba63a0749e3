"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
``repro.models.rglru``).

Block: x -> [W_in branch: causal depthwise conv (width W) -> RG-LRU]
⊙ gelu(W_gate x) -> W_out, with

    r_t = sigmoid(W_a y_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x y_t + b_x)            (input gate)
    log a_t = -8 · softplus(Λ) · r_t
    h_t = a_t ⊙ h_{t-1} + sqrt(max(1 - a_t², 1e-12)) ⊙ (i_t ⊙ y_t)

The gate's gelu is the tanh form (``jax.nn.gelu``'s default). The linear
scan runs in float32 over chunks of ``chunk`` tokens, ``h`` carried from one
chunk to the next (pad steps: ``a = 1``, input 0). Inside a chunk it is a
doubling scan: pass j (offset 2^j, j = 0 … log2(chunk) − 1) composes every
element with the one 2^j before it, ``(a, g) ← (a_prev · a, g_prev · a + g)``,
so after log2(chunk) passes element t holds the product of a_1 … a_t and
the sum of the g's carried to t; then ``h_t = A_t · h_0 + G_t``. The
reference's ``lax.associative_scan`` associates the same products in
another tree: the two agree to float32 rounding. Plain torch, as the
reference's is plain jnp: no kernel. Decode state: (conv tail [W-1], h).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Init

__all__ = ["init_rglru", "rglru_block", "init_rglru_state", "C_RGLRU"]

C_RGLRU = 8.0


def init_rglru(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d, r, W = cfg.d_model, cfg.d_rnn, cfg.conv_width
    f32 = torch.float32
    return {
        "w_in": init((d, r), ("embed_fsdp", "rnn"), dtype=dtype, stack=stack),
        "w_gate": init((d, r), ("embed_fsdp", "rnn"), dtype=dtype, stack=stack),
        "w_out": init((r, d), ("rnn", "embed_fsdp"), dtype=dtype, stack=stack),
        "conv_w": init((W, r), (None, "rnn"), dtype=dtype, scale=0.3, stack=stack),
        "conv_b": init((r,), ("rnn",), dtype=dtype, zeros=True, stack=stack),
        "w_a": init((r, r), ("rnn", None), dtype=dtype, stack=stack),
        "b_a": init((r,), ("rnn",), dtype=f32, zeros=True, stack=stack),
        "w_x": init((r, r), ("rnn", None), dtype=dtype, stack=stack),
        "b_x": init((r,), ("rnn",), dtype=f32, zeros=True, stack=stack),
        "lam": init((r,), ("rnn",), dtype=f32, scale=0.65, stack=stack),
    }


def _conv1d(y, w, b, tail):
    """Causal depthwise conv of width W; ``tail [B, W-1, r]`` carries the
    previous call's last inputs. Returns (out, new tail)."""
    W, S = w.shape[0], y.shape[1]
    ypad = torch.cat([tail.to(y.dtype), y], dim=1)
    out = ypad[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + ypad[:, i:i + S] * w[i]
    return out + b, ypad[:, -(W - 1):]


def _scan_chunk(a, g):
    """Inclusive scan of ``h_t = a_t h_{t-1} + g_t`` along axis 1 from h = 0:
    (A_t = a_1 ⋯ a_t, G_t), by doubling."""
    n, off = a.shape[1], 1
    while off < n:
        a_prev, g_prev = a[:, :-off], g[:, :-off]
        g = torch.cat([g[:, :off], g_prev * a[:, off:] + g[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a_prev * a[:, off:]], dim=1)
        off *= 2
    return a, g


def rglru_block(p, x, cfg: ModelConfig, state, *, chunk: int = 256):
    """``x [B, S, d]``; ``state = {conv [B, W-1, r], h [B, r] float32}``.
    Returns (out [B, S, d], new state)."""
    B, S, _ = x.shape
    y = torch.matmul(x, p["w_in"])
    gate = F.gelu(torch.matmul(x, p["w_gate"]), approximate="tanh")
    y, conv_tail = _conv1d(y, p["conv_w"], p["conv_b"], state["conv"])
    r_g = torch.sigmoid(torch.matmul(y, p["w_a"]) + p["b_a"])
    i_g = torch.sigmoid(torch.matmul(y, p["w_x"]) + p["b_x"])
    log_a = (-C_RGLRU * F.softplus(p["lam"]) * r_g).float()
    a = torch.exp(log_a)
    gated = (i_g * y).float() * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))

    nchunk = -(-S // chunk)
    pad = nchunk * chunk - S
    if pad:  # identity steps: a = 1, input 0
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        gated = F.pad(gated, (0, 0, 0, pad))
    h = state["h"].float()
    hs = []
    for c in range(nchunk):
        A, G = _scan_chunk(a[:, c * chunk:(c + 1) * chunk], gated[:, c * chunk:(c + 1) * chunk])
        hc = A * h[:, None] + G
        h = hc[:, -1]
        hs.append(hc)
    hs = torch.cat(hs, dim=1)[:, :S]
    out = torch.matmul(hs.to(x.dtype) * gate, p["w_out"])
    return out, {"conv": conv_tail, "h": h}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, *, device="cuda"):
    """Zeroed state of one layer: ``{conv [B, W-1, r] dtype, h [B, r] float32}``."""
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
    }
