"""Zamba2-1.2B [arXiv:2411.15242; hf Zyphra/Zamba2-1.2B] — Mamba2 backbone
with one shared attention+MLP block applied periodically on
[hidden ; original-embedding] (2*d_model wide). Per-application LoRA on the
shared block is omitted (noted in DESIGN.md)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=128, d_ff=8192, vocab_size=32000,
    mlp_type="gelu", rope_theta=1e4, norm_eps=1e-5,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=128, ssm_groups=1,
    shared_attn_every=6,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
