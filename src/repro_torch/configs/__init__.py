"""Architecture registry of the port: ``get_config(arch_id)`` + reduced smoke configs.

Every architecture of the reference registry (``repro.configs``) is
registered, in its order: the MoE family (phi3.5-moe, olmoe), rwkv6, the
Mamba+attention hybrid jamba, the dense family (smollm-360m, gemma3-27b,
yi-34b, gemma-7b with its int8 KV cache, musicgen-large) and llava, whose
backbone takes embedding inputs.  ``smoke_config`` is the reference's shrink
rule, unchanged (the MoE, Mamba and RWKV sub-configs shrink too, a pattern's
tail layer stays), so a smoke config here equals the JAX side's field for
field.  The assigned shape set (``configs.shapes``) is the reference's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    gemma3_27b,
    gemma_7b,
    jamba_1p5_large,
    llava_next_mistral_7b,
    musicgen_large,
    olmoe_1b_7b,
    phi35_moe_42b,
    rwkv6_1p6b,
    smollm_360m,
    yi_34b,
)
from repro_torch.configs.shapes import LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec, runnable_shapes, skip_reason
from repro_torch.models.config import ModelConfig

__all__ = [
    "ARCHS",
    "SHAPES",
    "ShapeSpec",
    "LONG_CONTEXT_ARCHS",
    "get_config",
    "smoke_config",
    "train_accum",
    "list_archs",
    "runnable_shapes",
    "skip_reason",
]

_MODULES = [
    phi35_moe_42b,
    olmoe_1b_7b,
    rwkv6_1p6b,
    jamba_1p5_large,
    smollm_360m,
    gemma3_27b,
    yi_34b,
    gemma_7b,
    musicgen_large,
    llava_next_mistral_7b,
]

ARCHS: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}
_ACCUM: dict[str, int] = {m.ARCH_ID: m.TRAIN_ACCUM for m in _MODULES}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)}")
    return ARCHS[arch_id]


def train_accum(arch_id: str) -> int:
    """Recommended gradient-accumulation microbatches (C per data rank) for train_4k."""
    return _ACCUM[arch_id]


def smoke_config(arch_id: str, seq: int = 64) -> ModelConfig:
    """Shrink to CPU scale, preserving structure. One pattern repetition
    (+ tail if the full config has one) so heterogeneous stacks are covered."""
    cfg = get_config(arch_id)
    pat = len(cfg.block_pattern)
    # keep a tail layer if the real config has one (gemma3: 62 % 6 == 2)
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
