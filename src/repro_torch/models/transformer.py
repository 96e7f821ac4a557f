"""Decoder-LM assembly for serving: parameters, caches, ``prefill`` and ``decode_step``.

The port of ``repro.models.transformer`` for attention layers with dense
MLPs.  The layer stack is a ``ModuleList`` walked by a Python loop where the
reference scans over its pattern-stacked ``body``; the cache likewise holds
one dict per layer.  Mamba, RWKV and MoE layers raise ``NotImplementedError``
until their slice.

Public entry points:
  init_params / compute_copy            parameters (seeded) and their compute-dtype copy
  init_cache / prefill / decode_step    serving
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import dense_init_, embed, rmsnorm
from repro_torch.models.mlp import MLP, mlp_apply

__all__ = ["Block", "Transformer", "init_params", "compute_copy", "init_cache", "prefill", "decode_step"]


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.kind != "attn":
            raise NotImplementedError(f"{spec.kind} layers wait for the recurrent-family slice of the port")
        if spec.moe:
            raise NotImplementedError("MoE layers wait for the recurrent and MoE slice of the port")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} waits for a later slice of the port")
    if cfg.embeds_input:
        raise NotImplementedError("embedding inputs wait for a later slice of the port")


class Block(nn.Module):
    """One attention layer with a dense MLP: ``norm1``, ``mixer``, ``norm2``,
    ``ffn`` (and ``norm1_post``/``norm2_post`` with ``post_block_norm``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device=None) -> None:
        super().__init__()
        self.spec = spec
        kw = dict(dtype=cfg.dtype("param"), device=device)
        names = ["norm1", "norm2"] + (["norm1_post", "norm2_post"] if cfg.post_block_norm else [])
        for name in names:
            setattr(self, name, nn.Parameter(torch.empty(cfg.d_model, **kw)))
        self.mixer = attn_lib.Attention(cfg, device)
        self.ffn = MLP(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, param in self.named_parameters(recurse=False):
            param.zero_()  # (1 + g) gains start at zero
        self.mixer.reset_parameters(generator)
        self.ffn.reset_parameters(generator)


class Transformer(nn.Module):
    """``embed`` (V, d), ``layers`` (one ``Block`` per layer, in execution
    order), ``final_norm`` (d,), and ``lm_head`` (d, V) unless embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype("param"), device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.layers = nn.ModuleList(Block(cfg, spec, device) for spec in cfg.layer_specs())
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.embed, generator, scale=self.cfg.d_model**-0.5)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.zero_()
        if not self.cfg.tie_embeddings:
            dense_init_(self.lm_head, generator)

    def out_weight(self) -> torch.Tensor:
        """(d, V): the tied embedding transposed, or the untied head."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda") -> Transformer:
    """Seeded parameters on ``device`` (the reference's init rule; torch's generator)."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.requires_grad_(False)


def compute_copy(params: Transformer) -> Transformer:
    """A copy whose matrices are in the compute dtype, made once at load.  The
    arithmetic is unchanged: every matrix is cast to the activation dtype at
    its use anyway (``layers.linear``, the embedding lookup, the logits); the
    norm gains stay in the parameter dtype, as the reference reads them."""
    dt = params.cfg.dtype("compute")
    out = copy.deepcopy(params)
    for param in out.parameters():
        if param.ndim >= 2:
            param.data = param.data.to(dt)
    return out


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, paged: attn_lib.PagedLayout | None = None, device=None
) -> dict:
    """The per-slot (continuous-batching) cache: {"index": (batch,), "layers": [...]}.

    Dense: each layer holds {"k","v": (batch, S_cache, Hkv, Dh), "pos": (batch,
    S_cache)}, with S_cache the window for local layers of a
    ``windowed_cache`` config.  ``paged``: each layer holds shared page pools
    instead, and the cache gains the page table ``pages`` (batch,
    pages_per_slot) int32 shared by every layer (-1 = unallocated)."""
    _check_supported(cfg)
    cache: dict = {"index": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if paged is not None:
        cache["pages"] = torch.full((batch, paged.pages_per_slot), -1, dtype=torch.int32, device=device)
    layers = []
    for spec in cfg.layer_specs():
        if paged is not None:
            layers.append(attn_lib.init_paged_kv_cache(cfg, paged, device=device))
        else:
            window = cfg.windowed_cache and spec.attn_type == "local"
            c = attn_lib.init_kv_cache(cfg, batch, max_seq, window=window, device=device)
            del c["index"]  # tracked once at the top level
            layers.append(c)
    cache["layers"] = layers
    return cache


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def _embed_in(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = cfg.dtype("compute")
    h = embed(params.embed, tokens, cdt)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=h.device)
    return h


def _logits(params: Transformer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = h @ params.out_weight().to(h.dtype)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _ffn_half(layer: Block, h: torch.Tensor, mix: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.post_block_norm:
        mix = rmsnorm(mix, layer.norm1_post, cfg.norm_eps)
    h = h + mix
    ffn = mlp_apply(layer.ffn, rmsnorm(h, layer.norm2, cfg.norm_eps), cfg)
    if cfg.post_block_norm:
        ffn = rmsnorm(ffn, layer.norm2_post, cfg.norm_eps)
    return h + ffn


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens (B,) -> (logits (B, V), cache).  The cache is
    updated in place and returned with ``index + 1``; ``pages`` is read-only
    here (the engine owns it)."""
    h = _embed_in(params, tokens[:, None], cfg)
    index = cache["index"]
    pages = cache.get("pages")
    for layer, layer_cache in zip(params.layers, cache["layers"]):
        c = dict(layer_cache, index=index)
        if pages is not None:
            c["pages"] = pages
        mix, _ = attn_lib.attention_decode(
            layer.mixer, rmsnorm(h, layer.norm1, cfg.norm_eps), c, cfg, layer.spec.attn_type
        )
        h = _ffn_half(layer, h, mix, cfg)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    cache["index"] = index + 1
    return _logits(params, h, cfg)[:, 0], cache


@torch.no_grad()
def prefill(
    params: Transformer,
    cache: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cfg: ModelConfig,
    attn_impl: str = "naive",
) -> tuple[torch.Tensor, dict]:
    """Batched prompt-parallel prefill: one forward over the whole padded prompt
    writes every layer's cache.

    tokens: (B, S_p) right-padded prompts; lengths: (B,) valid counts (1..S_p);
    cache: a dense per-slot cache from ``init_cache`` (read for its shapes,
    not modified).  Returns (logits at each row's last real token (B, V), a
    new cache with ``index == lengths``)."""
    h = _embed_in(params, tokens, cfg)
    lengths = lengths.to(torch.int32)
    layers = []
    for layer, layer_cache in zip(params.layers, cache["layers"]):
        mix, new_layer_cache = attn_lib.attention_prefill(
            layer.mixer, rmsnorm(h, layer.norm1, cfg.norm_eps), layer_cache, cfg, layer.spec.attn_type, lengths,
            impl=attn_impl,
        )
        h = _ffn_half(layer, h, mix, cfg)
        layers.append(new_layer_cache)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    last = h[torch.arange(h.shape[0], device=h.device), lengths.long() - 1]
    return _logits(params, last, cfg), {"index": lengths, "layers": layers}
