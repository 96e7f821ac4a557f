"""Architecture registry of the port: ``get_config(arch_id)`` + reduced smoke configs.

Only the architectures whose every layer the port can run are registered;
the rest of the reference registry (``repro.configs``) joins slice by slice.
``smoke_config`` is the reference's shrink rule, unchanged (the MoE, Mamba
and RWKV sub-configs shrink too), so a smoke config here equals the JAX
side's field for field.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import rwkv6_1p6b, smollm_360m
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "smoke_config"]

_MODULES = [rwkv6_1p6b, smollm_360m]

ARCHS: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: {list(ARCHS)}")
    return ARCHS[arch_id]


def smoke_config(arch_id: str, seq: int = 64) -> ModelConfig:
    """Shrink to CPU scale, preserving structure. One pattern repetition
    (+ tail if the full config has one) so heterogeneous stacks are covered."""
    cfg = get_config(arch_id)
    pat = len(cfg.block_pattern)
    n_layers = pat * (2 if pat == 1 else 1) + (1 if cfg.n_layers % pat else 0)
    n_heads = 4
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = max(1, n_heads // ratio)
    if n_heads % n_kv:
        n_kv = 1
    moe = (
        dataclasses.replace(
            cfg.moe,
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(cfg.moe.top_k, min(8, cfg.moe.n_experts)),
            d_ff_expert=64,
        )
        if cfg.moe
        else None
    )
    mamba = dataclasses.replace(cfg.mamba, d_inner=128, d_state=8, chunk=16) if cfg.mamba else None
    rwkv = dataclasses.replace(cfg.rwkv, head_dim=16, decay_lora=8, mix_lora=8, chunk=16) if cfg.rwkv else None
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        mamba=mamba,
        rwkv=rwkv,
        sliding_window=min(cfg.sliding_window, 32),
        max_seq=seq,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
