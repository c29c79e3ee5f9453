"""StarCoder2-7B [arXiv:2402.19173; hf bigcode/starcoder2-7b]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    head_dim=128, d_ff=18432, vocab_size=49152,
    mlp_type="gelu", rope_theta=1e5, norm_eps=1e-5,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
