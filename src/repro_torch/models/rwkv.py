"""RWKV-6 "Finch" blocks (arXiv:2404.05892): attention-free time mix with a
data-dependent decay, and channel mix (``repro.models.rwkv``).

Time mix, per head (head size N): the state ``S ∈ R^{N×N}`` evolves as

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with ``w_t = exp(-exp(ww_t))`` from a LoRA on the token-shifted input, and
token-shift interpolation (``sigmoid(mu)``) on every projection's input.
The projections are matmuls over the whole sequence; the recurrence is a
plain torch loop over the tokens (the reference's is plain ``lax.scan`` too:
no kernel). The reference scans chunks of 256 tokens whose trailing pad
steps carry decay 1 and ``k = v = 0``: they leave the state bit for bit as
it was, so a loop over the real tokens alone does the same arithmetic and
the port has no chunks (decode, the reference's ``chunk=1``, is the loop at
one token). The state is float32; ``k_t^T v_t`` is formed in the
projections' dtype and promoted where it meets the state, as jnp promotes
it. Decode carries (last token, S) per layer: O(1) per token.

Under autograd with ``cfg.rwkv_chunk_remat`` the loop runs in chunks of
``WKV_CHUNK`` tokens, each checkpointed as the reference checkpoints its
chunk scan: the backward then holds one chunk's per-token states
(``[B, H, N, N]`` each) at a time, not the whole sequence's. The chunks
change no number.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Init, rms_norm

__all__ = ["init_time_mix", "init_channel_mix", "time_mix", "channel_mix", "init_state"]

WKV_CHUNK = 256  # tokens per checkpointed chunk of the recurrence (the reference's chunk)


def _n_heads(cfg: ModelConfig) -> int:
    if cfg.d_model % cfg.rwkv_head_size:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the head size "
                         f"{cfg.rwkv_head_size}")
    return cfg.d_model // cfg.rwkv_head_size


def init_time_mix(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d = cfg.d_model
    H, N = _n_heads(cfg), cfg.rwkv_head_size
    lora = max(d // 16, 16)
    f32 = torch.float32
    return {
        "mu": init((5, d), (None, "embed"), dtype=f32, zeros=True, stack=stack),  # r, k, v, g, w
        "wr": init((d, d), ("embed_fsdp", "heads"), dtype=dtype, stack=stack),
        "wk": init((d, d), ("embed_fsdp", "heads"), dtype=dtype, stack=stack),
        "wv": init((d, d), ("embed_fsdp", "heads"), dtype=dtype, stack=stack),
        "wg": init((d, d), ("embed_fsdp", "heads"), dtype=dtype, stack=stack),
        "wo": init((d, d), ("heads", "embed_fsdp"), dtype=dtype, stack=stack),
        "w_base": init((d,), ("embed",), dtype=f32, zeros=True, stack=stack),
        "w_a": init((d, lora), ("embed_fsdp", None), dtype=dtype, stack=stack),
        "w_b": init((lora, d), (None, "embed_fsdp"), dtype=dtype, stack=stack),
        "u": init((H, N), ("heads", None), dtype=f32, zeros=True, stack=stack),
        "ln_x": init((d,), ("embed",), dtype=f32, zeros=True, stack=stack),
    }


def init_channel_mix(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": init((2, d), (None, "embed"), dtype=torch.float32, zeros=True, stack=stack),
        "wk": init((d, f), ("embed_fsdp", "mlp"), dtype=dtype, stack=stack),
        "wv": init((f, d), ("mlp", "embed_fsdp"), dtype=dtype, stack=stack),
        "wr": init((d, d), ("embed_fsdp", "embed"), dtype=dtype, stack=stack),
    }


def _token_shift(x, last):
    """shifted[t] = x[t-1]; position 0 takes ``last`` (carried across calls)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    """``x + mu·(xs − x)`` (float32, as ``mu`` is) cast back to ``x.dtype``."""
    return (x + mu * (xs - x)).to(x.dtype)


def _wkv(r32, k, v, w, u, St):
    """The recurrence over ``T`` tokens (``[B, T, H, N]`` each) from the
    state ``St`` -> (out [B, T, H, N] float32, final state)."""
    outs = []
    for t in range(r32.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B, H, N, N], the projections' dtype
        outs.append(torch.matmul(r32[:, t, :, None, :], St + u * kv)[:, :, 0])
        St = w[:, t, :, :, None] * St + kv
    return torch.stack(outs, dim=1), St


def time_mix(p, x, cfg: ModelConfig, state):
    """``x [B, S, d]``; ``state = (x_last [B, d], S [B, H, N, N])``.
    Returns (out [B, S, d], (x[:, -1], S_final float32))."""
    B, S, d = x.shape
    H, N = _n_heads(cfg), cfg.rwkv_head_size
    x_last, S0 = state
    xs = _token_shift(x, x_last)
    mu = torch.sigmoid(p["mu"])  # [5, d]
    xr, xk, xv, xg, xw = (_mix(x, xs, mu[i]) for i in range(5))
    r = torch.matmul(xr, p["wr"]).reshape(B, S, H, N)
    k = torch.matmul(xk, p["wk"]).reshape(B, S, H, N)
    v = torch.matmul(xv, p["wv"]).reshape(B, S, H, N)
    g = F.silu(torch.matmul(xg, p["wg"]))
    ww = p["w_base"] + torch.matmul(torch.matmul(xw.float(), p["w_a"].float()), p["w_b"].float())
    w = torch.exp(-torch.exp(ww.clamp(-20, 10))).reshape(B, S, H, N)  # decay in (0, 1)
    u = p["u"][None, :, :, None]
    r32 = r.float()  # r meets the float32 state
    St = S0.float()
    remat = cfg.rwkv_chunk_remat and torch.is_grad_enabled()
    outs = []
    for c in range(0, S, WKV_CHUNK):
        args = tuple(t[:, c:c + WKV_CHUNK] for t in (r32, k, v, w)) + (u, St)
        o, St = (checkpoint(_wkv, *args, use_reentrant=False, preserve_rng_state=False)
                 if remat else _wkv(*args))
        outs.append(o)
    out = torch.cat(outs, dim=1)  # [B, S, H, N] float32
    out = rms_norm(out.reshape(B, S, d), p["ln_x"], cfg.norm_eps) * g.to(out.dtype)
    return torch.matmul(out.to(x.dtype), p["wo"]), (x[:, -1], St)


def channel_mix(p, x, cfg: ModelConfig, x_last):
    """Squared-relu channel mix; returns (out [B, S, d], x[:, -1])."""
    xs = _token_shift(x, x_last)
    mu = torch.sigmoid(p["mu"])
    xk, xr = _mix(x, xs, mu[0]), _mix(x, xs, mu[1])
    kv = torch.matmul(torch.square(F.relu(torch.matmul(xk, p["wk"]))), p["wv"])
    out = torch.sigmoid(torch.matmul(xr, p["wr"])) * kv
    return out.to(x.dtype), x[:, -1]


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *, device="cuda"):
    """One layer's zeroed decode state ``{tm_x, tm_S (float32), cm_x}``."""
    H, N = _n_heads(cfg), cfg.rwkv_head_size
    return {
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "tm_S": torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }
