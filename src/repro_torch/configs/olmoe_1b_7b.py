"""olmoe-1b-7b — 64-expert top-8 MoE, QK-norm.

[arXiv:2409.02060; hf] 16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert
vocab=50304. ~7B total / ~1.3B active.
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "olmoe-1b-7b"
TRAIN_ACCUM = 4

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=(LayerSpec(moe=True),),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    qk_norm=True,
    mlp_gated=True,
    activation="silu",
    rope_theta=10_000.0,
    max_seq=4_096,
    param_dtype="bfloat16",
)
