"""HuBERT-XLarge [arXiv:2106.07447; hf facebook/hubert-xlarge-ll60k] —
encoder-only (no decode shapes); the conv waveform frontend is a STUB
(precomputed frame embeddings enter through input_specs). vocab = 504
masked-prediction cluster targets."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    head_dim=80, d_ff=5120, vocab_size=504,
    mlp_type="gelu", causal=False, norm_eps=1e-5,
    frontend="frame",
)


def smoke() -> ArchConfig:
    return CONFIG.reduced()
