"""starcoder2-15b — GQA kv=4, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    mlp_gated=False,  # classic c_fc/c_proj MLP
    qkv_bias=True,
    rope_theta=100_000.0,
)
