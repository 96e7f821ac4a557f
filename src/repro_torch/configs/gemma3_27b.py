"""gemma3-27b — 5:1 local:global attention, QK-norm, sandwich norms.

[hf:google/gemma-3-27b-pt; unverified] 62L d_model=5376 32H (GQA kv=16,
head_dim 128) d_ff=21504 vocab=262144, sliding window 1024 on local
layers, 128k context. 10 repeats of [5 local + 1 global] + 2-layer tail.
Runs long_500k (decode; 52/62 layers have a 1024-token window).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "gemma3-27b"
TRAIN_ACCUM = 8

_L = LayerSpec(attn_type="local")
_G = LayerSpec(attn_type="global")

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=(_L, _L, _L, _L, _L, _G),
    sliding_window=1024,
    qk_norm=True,
    post_block_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
    mlp_gated=True,
    activation="gelu",
    rope_theta=1_000_000.0,
    max_seq=131_072,
    param_dtype="bfloat16",
    # the reference's deploy default: ring-buffer KV of the window's length
    # for the 52 local layers
    windowed_cache=True,
)
