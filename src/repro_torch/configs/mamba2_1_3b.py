"""Mamba2-1.3B [arXiv:2405.21060; state-spaces/mamba2-1.3b] — SSD,
attention-free, d_state 128, expand 2, head_dim 64, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    tie_embeddings=True, norm_eps=1e-5,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=128, ssm_groups=1,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
