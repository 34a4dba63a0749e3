"""Model / shape configuration system (a copy of ``repro.configs.base``).

One ``ModelConfig`` covers all ten architecture families of the reference;
each ``repro_torch/configs/<arch>.py`` instantiates it with the exact public
hyperparameters. ``reduce_for_smoke`` shrinks any config to a CPU-runnable
same-family miniature (the port's CPU tests); ``chip_smoke.py`` runs the
dense family at full width on the card. Pure dataclasses: the port keeps its
own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "reduce_for_smoke"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    mlp_gated: bool = True  # False = classic 2-matrix MLP (starcoder2)
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, ...]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ("attn",)  # e.g. ("rec", "rec", "attn")
    local_window: int = 0  # sliding-window size for "attn" blocks (0 = full)
    d_rnn: int = 0
    conv_width: int = 4
    # --- rwkv ---
    rwkv_head_size: int = 64
    # --- encoder-decoder (whisper backbone) ---
    n_enc_layers: int = 0
    is_encdec: bool = False
    # --- numerics / memory ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # per-layer activation checkpoint policy
    rwkv_chunk_remat: bool = True  # checkpoint WKV chunks (§Perf rwkv6 log)
    decode_loop: str = "scan"  # scan | fori (fori: in-place stacked cache)
    # positional scheme notes
    attn_kind: str = "causal"  # causal | full (encoder)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        """Can serve 500k-token contexts (O(1)/O(window) decode state)."""
        return self.family in ("rwkv",) or (
            self.family == "hybrid" and self.local_window > 0
        )

    def param_count(self) -> int:
        """Closed-form parameter estimate (embeddings + blocks + head)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        att = d * hd * self.n_heads + 2 * d * hd * self.n_kv + hd * self.n_heads * d
        n_mats = 3 if self.mlp_gated else 2
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * self.d_expert + d * self.n_experts
        else:
            mlp = n_mats * d * self.d_ff
        if self.family == "rwkv":
            att = 5 * d * d + 2 * d  # time-mix r,k,v,g,o + decay params (approx)
            mlp = 2 * d * self.d_ff + d * d
        per_layer = att + mlp + 2 * d
        n_blocks = self.n_layers + self.n_enc_layers
        if self.family == "hybrid":
            n_rec = sum(1 for i in range(self.n_layers) if self.block_pattern[i % len(self.block_pattern)] == "rec")
            att_l = self.n_layers - n_rec
            rec = 2 * d * self.d_rnn + 2 * self.d_rnn + self.d_rnn * d + self.conv_width * self.d_rnn
            return emb + att_l * (att + mlp + 2 * d) + n_rec * (rec + mlp + 2 * d)
        return emb + n_blocks * per_layer

    def flops_per_token_train(self) -> float:
        """6*N (dense) / 6*N_active (MoE) — the §Roofline MODEL_FLOPS term."""
        n = self.param_count()
        if self.family == "moe":
            d = self.d_model
            dense_experts = self.n_experts * 3 * d * self.d_expert * self.n_layers
            active = n - dense_experts + self.moe_top_k * 3 * d * self.d_expert * self.n_layers
            return 6.0 * active
        return 6.0 * n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU smoke tests (one step, no NaNs)."""
    hd = min(cfg.hd, 16)
    heads = max(min(cfg.n_heads, 4), 1)
    kv = max(min(cfg.n_kv, heads), 1)
    kv = kv if heads % kv == 0 else heads
    mrope = None
    if cfg.mrope_sections is not None:
        q = (hd // 2) // 4
        mrope = (hd // 2 - 2 * q, q, q)
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, len(cfg.block_pattern) if cfg.family == "hybrid" else 2),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        d_model=64,
        n_heads=heads,
        n_kv=kv,
        head_dim=hd,
        d_ff=96,
        d_expert=48 if cfg.d_expert else 0,
        d_rnn=64 if cfg.d_rnn else 0,
        n_experts=min(cfg.n_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2),
        vocab=512,
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        mrope_sections=mrope,
        rwkv_head_size=16,
        param_dtype="float32",
        compute_dtype="float32",
    )
