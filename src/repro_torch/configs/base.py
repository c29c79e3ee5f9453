"""Architecture config system (the port's copy of the JAX package's
``configs/base.py``, field for field).

One ``ArchConfig`` describes every assigned architecture (dense / MoE /
SSM / hybrid / VLM / audio). Exact published configs live in the sibling
``<arch>.py`` modules; each also exposes a ``smoke()`` reduction used by
the CPU tests (same code path, tiny dims).

The port runs the dense family's serving and training paths
(``models/lm.py``: ``forward``, ``loss_fn`` and ``decode_step``). They
honour ``remat``, ``remat_group``, ``onehot_embed`` and ``ce_chunk``;
``scan_layers``, which steers XLA lowering, is kept so that one config
means the same in both packages (the port loops over layers in Python).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace

ARCH_IDS = [
    "starcoder2_7b", "deepseek_67b", "qwen3_4b", "nemotron_4_340b",
    "olmoe_1b_7b", "deepseek_v2_236b", "mamba2_1_3b", "zamba2_1_2b",
    "internvl2_26b", "hubert_xlarge",
]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads
    mlp_type: str = "swiglu"        # swiglu | squared_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True             # False for encoder-only (hubert)
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek-v2)
    moe_capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block applied every k SSM layers
    shared_attn_every: int = 0      # 0 → no shared block

    # modality frontend stub
    frontend: str = "none"          # none | patch | frame
    num_patches: int = 0            # vlm: image patch positions per sample

    # numerics / schedule
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_group: int = 0            # >1 → two-level checkpointing groups
    attention_impl: str = "dense"   # dense | flash | stub (probe-only)
    scan_layers: bool = True
    ce_chunk: int = 512             # chunked cross-entropy seq block
    onehot_embed: bool = False      # SPMD-friendly embedding (see layers)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def supports_decode(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """long_500k shape: only sub-quadratic (SSM/hybrid) families."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d            # embed
        if not self.tie_embeddings:
            total += v * d       # lm head
        per_layer_attn = 0
        if not self.attention_free:
            if self.use_mla:
                r, qr = self.kv_lora_rank, self.q_lora_rank
                qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                per_layer_attn = (d * qr + qr * self.num_heads * qk
                                  + d * (r + self.qk_rope_head_dim)
                                  + r * self.num_heads
                                  * (self.qk_nope_head_dim + self.v_head_dim)
                                  + self.num_heads * self.v_head_dim * d)
            else:
                per_layer_attn = d * n_q + 2 * d * n_kv + n_q * d
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        per_layer_mlp = mlp_mult * d * f if f else 0
        if self.num_experts:
            ef = self.moe_d_ff or f
            per_layer_mlp = (self.num_experts + self.num_shared_experts) \
                * mlp_mult * d * ef + d * self.num_experts
        per_layer_ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns = self.ssm_d_inner, self.ssm_state
            g = self.ssm_groups
            per_layer_ssm = (d * (2 * di + 2 * g * ns + self.ssm_heads)
                             + di * d + self.ssm_heads
                             + self.ssm_conv_width * (di + 2 * g * ns))
        if self.family in ("ssm", "hybrid"):
            per_layer = per_layer_ssm + d       # mamba blocks only
        else:
            per_layer = per_layer_attn + per_layer_mlp + 4 * d
        total += self.num_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            dd = 2 * d
            total += (dd * n_q + 2 * dd * n_kv + n_q * dd   # attn (2d wide)
                      + mlp_mult * dd * self.d_ff           # shared MLP
                      + dd * d                               # out_proj
                      + 3 * dd)                              # norms
        return int(total)

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test reduction: same family/flags, tiny dims."""
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = min(self.num_heads, 4) if self.num_heads else 0
        if heads and kv:
            heads = max(heads - heads % kv, kv)
        base = replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32 if heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.num_experts else 0,
            moe_capacity_factor=float(max(1, self.num_experts)),
            first_k_dense=min(self.first_k_dense, 1),
            kv_lora_rank=32 if self.use_mla else 0,
            q_lora_rank=48 if self.use_mla else 0,
            qk_rope_head_dim=16 if self.use_mla else 0,
            qk_nope_head_dim=16 if self.use_mla else 0,
            v_head_dim=32 if self.use_mla else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssm_chunk=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            num_patches=8 if self.frontend == "patch" else 0,
            ce_chunk=64,
        )
        return replace(base, **overrides)


# ---------------------------------------------------------------------------
# input shapes assigned to the LM family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) per the assignment's skip rules."""
    if shape.is_decode and not cfg.supports_decode():
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, "full attention is quadratic at 500k; " \
                      "needs SSM/hybrid"
    return True, ""


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    if hasattr(mod, "smoke"):
        return mod.smoke()
    return mod.CONFIG.reduced()
