"""OLMoE-1B-7B [arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924] —
64 experts, top-8, per-expert FFN width 1024, MHA (kv == heads)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1024, vocab_size=50304,
    mlp_type="swiglu", qk_norm=True, rope_theta=1e4, norm_eps=1e-5,
    num_experts=64, experts_per_token=8, moe_d_ff=1024,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
