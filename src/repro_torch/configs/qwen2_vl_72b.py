"""qwen2-vl-72b — VLM backbone only (patch frontend STUBBED), M-RoPE
[arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=29568,
    vocab=152064,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w over head_dim/2 = 64
)
