"""llava-next-mistral-7b — mistral-7B backbone, anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The anyres patch/tiling frontend is a
stub: ``input_specs()`` provides precomputed, projected patch embeddings
concatenated with text embeddings — the backbone consumes (B, S, d) floats
(``embeds_input=True``).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "llava-next-mistral-7b"
TRAIN_ACCUM = 8

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(LayerSpec(),),
    mlp_gated=True,
    activation="silu",
    rope_theta=1_000_000.0,
    max_seq=32_768,
    embeds_input=True,
    param_dtype="bfloat16",
)
