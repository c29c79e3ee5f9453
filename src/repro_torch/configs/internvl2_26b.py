"""InternVL2-26B [arXiv:2404.16821; hf OpenGVLab/InternVL2-26B] — the
InternLM2-20B language backbone; the InternViT-6B vision tower is a STUB
(precomputed patch embeddings enter through input_specs)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92553,
    mlp_type="swiglu", rope_theta=1e6, norm_eps=1e-5,
    frontend="patch", num_patches=256,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
