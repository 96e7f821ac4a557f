"""Model configuration schema (a copy of ``repro.models.config`` with torch dtypes).

One :class:`ModelConfig` describes every architecture in the assigned pool:
dense / MoE / SSM (RWKV6) / hybrid (Mamba+attention) decoder LMs, with GQA,
sliding-window attention, gated MLPs, tied embeddings, etc.

Layer heterogeneity (jamba's 1:7 attn:mamba interleave, gemma3's 5:1
local:global) is expressed as a repeating ``block_pattern`` of
:class:`LayerSpec` — the transformer stacks parameters per *pattern group*
and scans over repeats, so compile time stays O(pattern), not O(layers).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["LayerSpec", "MoEConfig", "MambaConfig", "RWKVConfig", "ModelConfig"]

LayerKind = Literal["attn", "mamba", "rwkv"]
AttnType = Literal["global", "local"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's shape within the repeating block pattern."""

    kind: LayerKind = "attn"
    attn_type: AttnType = "global"
    moe: bool = False  # MoE MLP instead of dense MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss
    router_z_weight: float = 1e-3  # router logit z-loss


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_inner: int  # usually 2 * d_model
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # associative-scan chunk (memory/perf knob)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # low-rank size for data-dependent decay (RWKV6 'Finch')
    mix_lora: int = 32  # low-rank size for token-shift mixing
    chunk: int = 32  # chunked-recurrence length (<=32: overflow-free, see rwkv.py)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    block_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    # MLP
    mlp_gated: bool = True
    activation: Literal["silu", "gelu"] = "silu"
    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 4096  # for attn_type == "local" layers
    attn_logit_softcap: float = 0.0  # 0 = off (gemma3 uses soft-capping)
    final_logit_softcap: float = 0.0
    qk_norm: bool = False  # gemma3 QK-norm
    # embeddings / norms
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: * sqrt(d_model)
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    post_block_norm: bool = False  # gemma3 sandwich norm
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training
    max_seq: int = 8192
    remat: bool = True
    remat_policy: Literal["none", "minimal", "full"] = "full"
    # serving perf lever (EXPERIMENTS.md §Perf): local-attention layers keep a
    # ring-buffer KV cache of `sliding_window` slots instead of the full
    # context (gemma3 long_500k: 52/62 layers need 1024 of 524288 positions)
    windowed_cache: bool = False
    # serving perf lever: int8 KV cache with per-(position, head) scales —
    # halves cache bytes and per-token cache reads (gemma-7b decode_32k:
    # 16.3 GB/dev OOM -> fits)
    kv_cache_dtype: Literal["compute", "int8"] = "compute"
    # modality stub: inputs arrive as precomputed embeddings, not token ids
    embeds_input: bool = False

    # ------------------------------------------------------------------

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads={self.n_heads} not a multiple of n_kv_heads={self.n_kv_heads}")
        needs = {s.kind for s in self.block_pattern}
        if "mamba" in needs and self.mamba is None:
            raise ValueError(f"{self.name}: mamba layers present but no MambaConfig")
        if "rwkv" in needs and self.rwkv is None:
            raise ValueError(f"{self.name}: rwkv layers present but no RWKVConfig")
        if any(s.moe for s in self.block_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: MoE layers present but no MoEConfig")
        if self.rwkv is not None and self.d_model % self.rwkv.head_dim != 0:
            raise ValueError(f"{self.name}: d_model must be divisible by rwkv head_dim")

    # -- layer-plan helpers -------------------------------------------------

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_repeats(self) -> int:
        """Full repeats of the block pattern."""
        return self.n_layers // self.pattern_len

    @property
    def tail_layers(self) -> tuple[LayerSpec, ...]:
        """Layers left over after the repeating part (kept in order)."""
        rem = self.n_layers % self.pattern_len
        return self.block_pattern[:rem]

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        """All n_layers specs in execution order."""
        full = self.block_pattern * self.n_repeats + self.tail_layers
        assert len(full) == self.n_layers
        return full

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.block_pattern)

    @property
    def has_full_attention(self) -> bool:
        """True if any layer does unwindowed global attention (quadratic)."""
        return any(s.kind == "attn" and s.attn_type == "global" for s in self.block_pattern)

    def dtype(self, which: Literal["param", "compute"]) -> torch.dtype:
        return getattr(torch, self.param_dtype if which == "param" else self.compute_dtype)

    # -- parameter counting (for roofline MODEL_FLOPS and memory planning) ---

    def param_count(self) -> dict[str, int]:
        """Analytic parameter counts; validated against real pytrees in tests."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        counts: dict[str, int] = {"embed": V * d}
        if not self.tie_embeddings:
            counts["lm_head"] = d * V
        counts["final_norm"] = d
        per_kind: dict[str, int] = {}
        # attention layer
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_mlp = (3 if self.mlp_gated else 2) * d * ff
        per_norm = d if self.norm == "rmsnorm" else 2 * d  # layernorm has a bias
        norms = 2 * per_norm + (2 * per_norm if self.post_block_norm else 0)
        if self.qk_norm:
            attn += 2 * self.head_dim
        per_kind["attn"] = attn + norms
        if self.mamba is not None:
            m = self.mamba
            dtr = m.resolved_dt_rank(d)
            mam = (
                d * 2 * m.d_inner  # in_proj (x and z branches)
                + m.d_conv * m.d_inner  # depthwise conv
                + m.d_inner * (dtr + 2 * m.d_state)  # x -> dt, B, C
                + dtr * m.d_inner  # dt_proj
                + m.d_inner * m.d_state  # A_log
                + m.d_inner  # D
                + m.d_inner * d  # out_proj
            )
            per_kind["mamba"] = mam + norms
        if self.rwkv is not None:
            r = self.rwkv
            tm = (
                4 * d * d  # r, k, v, output matrices
                + d * d  # gate
                + d * r.decay_lora + r.decay_lora * d  # decay lora
                + 5 * (d * r.mix_lora + r.mix_lora * d)  # token-shift loras (w,k,v,r,g)
                + 2 * d  # u bonus + base decay
                + 6 * d  # maa_x + maa_base
                + 2 * d  # group-norm (ln_x) gain + bias
            )
            cm = 2 * d * ff + d * d + 2 * d  # key(d,ff), value(ff,d), recept(d,d), mix
            per_kind["rwkv"] = tm + cm + 2 * per_norm  # ln1 + ln2 (layernorm)
        if self.moe is not None:
            mo = self.moe
            per_kind["moe_mlp"] = d * mo.n_experts + mo.n_experts * (
                (3 if self.mlp_gated else 2) * d * mo.d_ff_expert
            )
        total_layers = 0
        for spec in self.layer_specs():
            if spec.kind == "attn":
                total_layers += per_kind["attn"]
                total_layers += per_kind["moe_mlp"] if spec.moe else dense_mlp
            elif spec.kind == "mamba":
                total_layers += per_kind["mamba"]
                total_layers += per_kind["moe_mlp"] if spec.moe else dense_mlp
            elif spec.kind == "rwkv":
                total_layers += per_kind["rwkv"]  # rwkv carries its own channel-mix
        counts["layers"] = total_layers
        counts["total"] = sum(v for k, v in counts.items() if k != "total")
        return counts

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()["total"]
        mo = self.moe
        full = self.param_count()["total"]
        n_moe_layers = sum(1 for s in self.layer_specs() if s.moe)
        per_expert = (3 if self.mlp_gated else 2) * self.d_model * mo.d_ff_expert
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * per_expert
        return full - inactive
