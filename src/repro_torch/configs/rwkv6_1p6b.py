"""rwkv6-1.6b ("Finch") — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified] 24L d_model=2048 d_ff=7168 vocab=65536.
head_dim 64 (32 heads). LayerNorm (RWKV convention). Runs long_500k
(state-space: O(1) per decoded token).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-1.6b"
TRAIN_ACCUM = 4

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / rwkv head_dim — informational for sharding
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=(LayerSpec(kind="rwkv"),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, chunk=32),
    norm="layernorm",
    max_seq=1_048_576,
    param_dtype="bfloat16",
)
