"""smollm-360m — llama-arch small, tied embeddings.

[hf:HuggingFaceTB/SmolLM-360M; hf] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "smollm-360m"
TRAIN_ACCUM = 2

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=(LayerSpec(),),
    tie_embeddings=True,
    mlp_gated=True,
    activation="silu",
    rope_theta=10_000.0,
    max_seq=2_048,
)
