"""gemma-2b — MQA (kv=1), GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)
