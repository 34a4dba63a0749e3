"""recurrentgemma-9b — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="gelu",
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    d_rnn=4096,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
)
