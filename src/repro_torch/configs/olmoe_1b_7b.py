"""olmoe-1b-7b — 64 experts top-8, MHA [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    d_expert=1024,
    vocab=50304,
    act="silu",
    n_experts=64,
    moe_top_k=8,
    qk_norm=True,
)
