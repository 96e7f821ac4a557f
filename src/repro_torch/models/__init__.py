"""The port's model code: training and serving forward passes in PyTorch over the CUDA kernels."""

from repro_torch.models.attention import PagedLayout
from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, MoEConfig, RWKVConfig
from repro_torch.models.transformer import (
    Transformer,
    compute_copy,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "LayerSpec",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "PagedLayout",
    "RWKVConfig",
    "Transformer",
    "compute_copy",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "prefill",
]
