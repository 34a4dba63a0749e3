"""granite-8b — llama-arch code model, GQA kv=8 [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=49152,
    act="silu",
    rope_theta=10_000.0,
)
