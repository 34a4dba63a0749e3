"""qwen3-moe-235b-a22b — 94L, 128 experts top-8, GQA kv=4, QK-norm
[hf:Qwen/Qwen3-235B-A22B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    head_dim=128,
    d_ff=1536,
    d_expert=1536,
    vocab=151936,
    act="silu",
    n_experts=128,
    moe_top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
