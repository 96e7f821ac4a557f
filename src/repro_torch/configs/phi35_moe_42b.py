"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, every layer.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400/expert vocab=32064.  ~42B total / ~6.6B active params
(validated against ModelConfig.param_count in tests).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
TRAIN_ACCUM = 8

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=(LayerSpec(moe=True),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    mlp_gated=True,
    activation="silu",
    rope_theta=10_000.0,
    max_seq=131_072,
    param_dtype="bfloat16",
)
