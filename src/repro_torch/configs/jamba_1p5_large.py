"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, 16-expert MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 on every second layer, attention every 8th
layer (offset 4). 9 repeats of an 8-layer superblock. ~398B total.
Runs long_500k (mamba-dominant; the 9 attention layers decode O(S)).
"""

from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, MoEConfig

ARCH_ID = "jamba-1.5-large-398b"
TRAIN_ACCUM = 16

_M = LayerSpec(kind="mamba", moe=False)
_ME = LayerSpec(kind="mamba", moe=True)
_A = LayerSpec(kind="attn", moe=False)
_AE = LayerSpec(kind="attn", moe=True)

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    # layer l: attention iff l % 8 == 4; MoE iff l % 2 == 1
    block_pattern=(_M, _ME, _M, _ME, _A, _ME, _M, _ME),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_inner=16384, d_state=16, d_conv=4, chunk=256),
    mlp_gated=True,
    activation="silu",
    rope_theta=10_000.0,
    max_seq=262_144,
    param_dtype="bfloat16",
)
