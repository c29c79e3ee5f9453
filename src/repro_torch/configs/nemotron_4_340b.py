"""Nemotron-4-340B [arXiv:2402.16819 / 2406.11704] — squared-ReLU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    head_dim=192, d_ff=73728, vocab_size=256000,
    mlp_type="squared_relu", rope_theta=1e4, norm_eps=1e-5,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
