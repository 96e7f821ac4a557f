"""gemma-7b — GeGLU, head_dim=256, MQA-style wide KV (kv=16 == heads).

[arXiv:2403.08295; hf] 28L d_model=3072 16H (kv=16) d_ff=24576
vocab=256000, tied + scaled embeddings.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "gemma-7b"
TRAIN_ACCUM = 8

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    block_pattern=(LayerSpec(),),
    tie_embeddings=True,
    scale_embeddings=True,
    mlp_gated=True,
    activation="gelu",
    rope_theta=10_000.0,
    max_seq=8_192,
    param_dtype="bfloat16",
    # the reference's deploy default: head_dim=256 x kv=16 makes the cache the
    # largest per parameter of any assigned arch; int8 KV halves its bytes
    kv_cache_dtype="int8",
)
