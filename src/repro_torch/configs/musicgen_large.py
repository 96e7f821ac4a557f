"""musicgen-large — decoder-only over EnCodec tokens (audio backbone stub).

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
Classic non-gated GELU FFN + LayerNorm. The EnCodec frontend is a stub:
``input_specs()`` provides precomputed codebook token streams (the assigned
backbone-only contract).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "musicgen-large"
TRAIN_ACCUM = 4

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(LayerSpec(),),
    mlp_gated=False,
    activation="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq=32_768,
    param_dtype="bfloat16",
)
