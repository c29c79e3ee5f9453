"""Qwen3-4B [hf Qwen/Qwen3-4B] — qk-norm + GQA, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=9728, vocab_size=151936,
    mlp_type="swiglu", qk_norm=True, rope_theta=1e6,
    tie_embeddings=True, norm_eps=1e-6,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
