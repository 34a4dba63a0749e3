"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / head_size
    n_kv=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_size=64,
    act="relu_sq",        # channel-mix uses squared relu internally
)
