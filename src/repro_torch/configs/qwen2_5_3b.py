"""qwen2.5-3b — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv=2,
    d_ff=11008,
    vocab=151936,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
