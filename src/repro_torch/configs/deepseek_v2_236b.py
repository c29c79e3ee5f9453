"""DeepSeek-V2-236B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2] —
MLA (kv_lora 512), 2 shared + 160 routed experts top-6, first layer dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    mlp_type="swiglu", rope_theta=1e4, norm_eps=1e-6,
    num_experts=160, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1536, first_k_dense=1,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
