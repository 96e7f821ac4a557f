"""yi-34b — llama-arch GQA dense.

[arXiv:2403.04652; hf] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "yi-34b"
# the reference's choice of 16 microbatches (micro_bs=1 a rank) over 8, for memory
TRAIN_ACCUM = 16

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=(LayerSpec(),),
    mlp_gated=True,
    activation="silu",
    rope_theta=5_000_000.0,
    max_seq=200_000,
    param_dtype="bfloat16",
)
