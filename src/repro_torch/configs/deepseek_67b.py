"""DeepSeek-67B [arXiv:2401.02954; hf deepseek-ai/deepseek-llm-67b-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=102400,
    mlp_type="swiglu", rope_theta=1e4, norm_eps=1e-6,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
