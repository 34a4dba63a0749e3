"""whisper-tiny — enc-dec backbone; conv frontend STUBBED [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="encdec",
    is_encdec=True,
    n_layers=4,          # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm_eps=1e-5,
    qkv_bias=True,
)
