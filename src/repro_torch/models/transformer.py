"""Decoder-LM assembly: parameters, ``forward``/``loss_fn`` for training, caches, ``prefill`` and ``decode_step``.

The port of ``repro.models.transformer`` for every architecture of the
registry: attention layers (the KV cache in the compute dtype or int8),
Mamba layers and RWKV6 layers, each attention or Mamba layer with a dense
MLP or a Mixture-of-Experts ffn, under RMSNorm or LayerNorm.  The layer
stack is a ``ModuleList`` walked by a Python loop where the reference scans
over its pattern-stacked ``body``; the cache likewise holds one dict per
layer.  With ``cfg.embeds_input`` (llava) ``forward`` and ``prefill`` take
(B, S, d) float embeddings in place of token ids; ``decode_step`` takes the
sampled token's id, whose embedding row is what the reference's engine
feeds its decode step.  The MoE auxiliary losses of every MoE layer are
summed into ``forward``'s ``moe_aux``, which ``loss_fn`` adds.

Public entry points:
  init_params / compute_copy            parameters (seeded) and their compute-dtype copy
  forward / loss_fn / unit_parameters   training (and the units a train step may hook)
  init_cache / prefill / decode_step    serving
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import dense_init_, embed, make_norm, norm_apply
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.moe import MOE_GROUP, MoE, moe_apply
from repro_torch.obs.ranges import region

__all__ = [
    "Block",
    "Transformer",
    "init_params",
    "compute_copy",
    "forward",
    "loss_fn",
    "unit_parameters",
    "init_cache",
    "prefill",
    "decode_step",
]


def _zero_norm(norm: nn.Module | nn.Parameter) -> None:
    for param in [norm] if isinstance(norm, nn.Parameter) else norm.parameters():
        param.zero_()  # (1 + g) gains and biases start at zero


class Block(nn.Module):
    """One layer.  Attention or Mamba: ``norm1``, ``mixer`` (``Attention`` or
    ``Mamba``), ``norm2``, ``ffn`` (``MLP``, or ``MoE`` where the spec says
    so), and ``norm1_post``/``norm2_post`` with ``post_block_norm``; each
    norm is a (d,) RMSNorm gain or a ``LayerNorm`` gain/bias pair.  RWKV6:
    only ``rwkv``, which carries its own norms and both residuals."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device=None) -> None:
        super().__init__()
        self.spec = spec
        if spec.kind == "rwkv":
            self.rwkv = rwkv_lib.RWKV(cfg, device)
            self.norms = []
            return
        self.norms = ["norm1", "norm2"] + (["norm1_post", "norm2_post"] if cfg.post_block_norm else [])
        for name in self.norms:
            setattr(self, name, make_norm(cfg.norm, cfg.d_model, cfg.dtype("param"), device))
        self.mixer = attn_lib.Attention(cfg, device) if spec.kind == "attn" else mamba_lib.Mamba(cfg, device)
        self.ffn = MoE(cfg, device) if spec.moe else MLP(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.spec.kind == "rwkv":
            self.rwkv.reset_parameters(generator)
            return
        for name in self.norms:
            _zero_norm(getattr(self, name))
        self.mixer.reset_parameters(generator)
        self.ffn.reset_parameters(generator)


class Transformer(nn.Module):
    """``embed`` (V, d), ``layers`` (one ``Block`` per layer, in execution
    order), ``final_norm`` (a (d,) gain, or a gain/bias pair under LayerNorm),
    and ``lm_head`` (d, V) unless embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype("param"), device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.layers = nn.ModuleList(Block(cfg, spec, device) for spec in cfg.layer_specs())
        self.final_norm = make_norm(cfg.norm, cfg.d_model, cfg.dtype("param"), device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.embed, generator, scale=self.cfg.d_model**-0.5)
        for layer in self.layers:
            layer.reset_parameters(generator)
        _zero_norm(self.final_norm)
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


def compute_copy(params: Transformer, cfg: ModelConfig | None = None) -> Transformer:
    """A copy whose matrices are in the compute dtype of ``cfg`` (default: the
    parameters' own config), made once at load.  The
    arithmetic is unchanged: every matrix is cast to the activation dtype at
    its use anyway (``layers.linear``, the embedding lookup, the logits); the
    norm gains and other vectors stay in the parameter dtype, as the
    reference reads them.  The rule: a matrix that the reference reads in
    float32 (a module's ``READ_IN_FP32``: RWKV's ``decay_w2``, the MoE
    ``router``, Mamba's ``A_log``) is never narrowed.

    Only a matrix that changes dtype gets new storage: every other parameter
    object is shared with ``params`` (neither side writes its parameters when
    serving), so a model already in its compute dtype costs no second copy."""
    dt = (cfg or params.cfg).dtype("compute")
    memo = {}
    for module in params.modules():
        keep = getattr(module, "READ_IN_FP32", ())
        for name, param in module.named_parameters(recurse=False):
            if param.ndim >= 2 and name not in keep and param.dtype != dt:
                memo[id(param)] = nn.Parameter(param.data.to(dt), requires_grad=param.requires_grad)
            else:
                memo[id(param)] = param
    return copy.deepcopy(params, memo)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, paged: attn_lib.PagedLayout | None = None, device=None
) -> dict:
    """The per-slot (continuous-batching) cache: {"index": (batch,), "layers": [...]}.

    Dense: each attention layer holds {"k","v": (batch, S_cache, Hkv, Dh),
    "pos": (batch, S_cache)}, with S_cache the window for local layers of a
    ``windowed_cache`` config.  ``paged``: each attention layer holds shared
    page pools instead, and the cache gains the page table ``pages`` (batch,
    pages_per_slot) int32 shared by every layer (-1 = unallocated).  A
    recurrent layer holds its per-slot state either way: RWKV6 {"tm_last",
    "cm_last", "state"}, Mamba {"conv", "ssm"}."""
    cache: dict = {"index": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if paged is not None:
        cache["pages"] = torch.full((batch, paged.pages_per_slot), -1, dtype=torch.int32, device=device)
    layers = []
    for spec in cfg.layer_specs():
        if spec.kind == "rwkv":
            layers.append(rwkv_lib.init_rwkv_cache(cfg, batch, device=device))
        elif spec.kind == "mamba":
            layers.append(mamba_lib.init_mamba_cache(cfg, batch, device=device))
        elif paged is not None:
            layers.append(attn_lib.init_paged_kv_cache(cfg, paged, device=device))
        else:
            window = cfg.windowed_cache and spec.attn_type == "local"
            c = attn_lib.init_kv_cache(cfg, batch, max_seq, window=window, device=device)
            del c["index"]  # tracked once at the top level
            layers.append(c)
    cache["layers"] = layers
    return cache


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _embed_in(params: Transformer, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) looked up in ``embed``, or, with ``cfg.embeds_input``,
    float embeddings (B, S, d) taken as they are; cast to the compute dtype,
    then scaled by sqrt(d) under ``scale_embeddings``."""
    cdt = cfg.dtype("compute")
    if cfg.embeds_input and inputs.is_floating_point() and inputs.ndim == 3:
        h = inputs.to(cdt)
    else:
        h = embed(params.embed, inputs, cdt)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=h.device)
    return h


def _logits(params: Transformer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = h @ params.out_weight().to(h.dtype)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    return norm_apply(x, p, cfg.norm, cfg.norm_eps)


def _ffn_half(
    layer: Block, h: torch.Tensor, mix: torch.Tensor, cfg: ModelConfig, moe_group: int = MOE_GROUP, moe_metrics=None,
    moe_routes=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The mixer's residual, then the ffn sub-block with its own.  Returns
    (h, the MoE layer's weighted auxiliary loss or None).  ``moe_group``: the
    MoE layer's token group; ``moe_metrics``, a list, receives its metrics;
    ``moe_routes``, an iterator, gives its expert choice (``moe_apply``'s ``top_idx``).
    The ffn runs in the range ``repro.model.moe`` or ``repro.model.mlp``
    (``obs.ranges``; its backward in ``<name>.bwd``)."""
    if cfg.post_block_norm:
        mix = _norm(mix, layer.norm1_post, cfg)
    h = h + mix
    hi = _norm(h, layer.norm2, cfg)
    aux = None
    if layer.spec.moe:
        route = next(moe_routes) if moe_routes is not None else None
        with region("repro.model.moe") as r:
            ffn, metrics = moe_apply(layer.ffn, r.input(hi), cfg, group_size=moe_group, top_idx=route)
            ffn = r.output(ffn)
        mo = cfg.moe
        aux = mo.router_aux_weight * metrics["aux_loss"] + mo.router_z_weight * metrics["z_loss"]
        if moe_metrics is not None:
            moe_metrics.append(metrics)
    else:
        with region("repro.model.mlp") as r:
            ffn = r.output(mlp_apply(layer.ffn, r.input(hi), cfg))
    if cfg.post_block_norm:
        ffn = _norm(ffn, layer.norm2_post, cfg)
    return h + ffn, aux


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def _train_layer(
    layer: Block, h: torch.Tensor, cfg: ModelConfig, attn_impl: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer; returns (h, its MoE auxiliary loss, the expert choices its
    capacity kept), both 0 for a dense ffn.  An attention mixer runs in the
    range ``repro.model.attn`` (``obs.ranges``)."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if layer.spec.kind == "rwkv":
        return rwkv_lib.rwkv_train(layer.rwkv, h, cfg), zero, zero  # the block adds its own residuals
    hi = _norm(h, layer.norm1, cfg)
    if layer.spec.kind == "attn":
        with region("repro.model.attn") as r:
            mix = attn_lib.attention_train(layer.mixer, r.input(hi), cfg, layer.spec.attn_type, impl=attn_impl)
            mix = r.output(mix)
    else:
        mix = mamba_lib.mamba_train(layer.mixer, hi, cfg)
    moe: list = []
    h, aux = _ffn_half(layer, h, mix, cfg, moe_metrics=moe)
    if aux is None:
        return h, zero, zero
    return h, aux, moe[0]["routed"].sum(dtype=torch.float32)


def unit_parameters(params: Transformer) -> dict[str, list[str]]:
    """The parameters (``named_parameters`` names) each unit of the training
    forward reads: ``"embed"``, ``"layers.<i>"``, and ``"head"`` (the final
    norm and the output matrix, which is the embedding again where tied)."""
    units: dict[str, list[str]] = {}
    for name, _ in params.named_parameters():
        top = name.split(".")
        key = "embed" if top[0] == "embed" else f"layers.{top[1]}" if top[0] == "layers" else "head"
        units.setdefault(key, []).append(name)
    if params.cfg.tie_embeddings:
        units["head"].append("embed")
    return units


def _unit(params: Transformer, name: str):
    """The context of one unit of the training forward (``"embed"``,
    ``"layers.<i>"``, ``"head"``): ``params.unit_hook(name)`` where a train
    step set one (``dist.hetero_step`` gathers the unit's sharded parameters
    there for the unit's use), else nothing."""
    hook = getattr(params, "unit_hook", None)
    return contextlib.nullcontext() if hook is None else hook(name)


def _train_unit(params: Transformer, i: int, h: torch.Tensor, cfg: ModelConfig, attn_impl: str):
    """Layer ``i`` inside its unit's context (so a recomputation enters it again)."""
    with _unit(params, f"layers.{i}"):
        return _train_layer(params.layers[i], h, cfg, attn_impl)


def _trunk(params: Transformer, inputs: torch.Tensor, cfg: ModelConfig, attn_impl: str) -> tuple[torch.Tensor, dict]:
    """The embedding and the layers of the training forward:
    (h (B, S, d), {"moe_aux", "moe_kept", "moe_choices"})."""
    with _unit(params, "embed"):
        h = _embed_in(params, inputs, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    kept_total = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and cfg.remat_policy != "none"
    choices = 0
    for i in range(len(params.layers)):
        if remat:
            h, aux, kept = checkpoint(_train_unit, params, i, h, cfg, attn_impl, use_reentrant=False)
        else:
            h, aux, kept = _train_unit(params, i, h, cfg, attn_impl)
        aux_total = aux_total + aux
        if params.layers[i].spec.moe:
            kept_total = kept_total + kept
            choices += h.shape[0] * h.shape[1] * cfg.moe.top_k
    return h, {"moe_aux": aux_total, "moe_kept": kept_total, "moe_choices": float(choices)}


def forward(
    params: Transformer, inputs: torch.Tensor, cfg: ModelConfig, attn_impl: str = "blocked"
) -> tuple[torch.Tensor, dict]:
    """Training forward: tokens (B, S), or (B, S, d) float embeddings with
    ``cfg.embeds_input`` -> (logits (B, S, V), {"moe_aux", "moe_kept", "moe_choices"}).

    Computes in ``cfg.compute_dtype`` with every cast inside the graph
    (``linear`` casts each weight at its use, the embedding lookup and the
    logits cast too), so gradients reach the parameters in their own dtype.
    Under ``cfg.remat`` each layer is a ``torch.utils.checkpoint`` region, as
    the reference checkpoints each layer: its backward keeps one layer's
    activations at a time.  ``remat_policy="minimal"`` (the reference saves
    the matmul outputs) recomputes everything too: the values are the same.
    RWKV layers run ``rwkv.rwkv_train`` with the ``chunked`` WKV, as the
    reference trains them.  ``moe_aux`` sums ``router_aux_weight·aux_loss +
    router_z_weight·z_loss`` over the MoE layers (0 without them);
    ``moe_kept`` (float32, on the device) counts the expert choices their
    capacity kept and ``moe_choices`` (a float) the choices made (tokens x
    top-k), both over the MoE layers.  Each unit (the embedding, a layer,
    the final norm with the logits) runs in the context of
    ``params.unit_hook`` where set (:func:`_unit`), a layer's inside its
    checkpoint region."""
    h, metrics = _trunk(params, inputs, cfg, attn_impl)
    with _unit(params, "head"):
        h = _norm(h, params.final_norm, cfg)
        logits = _logits(params, h, cfg)
    return logits, metrics


def loss_fn(
    params: Transformer, batch: dict, cfg: ModelConfig, attn_impl: str = "blocked"
) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy; batch: {"inputs", "targets", optional "mask"}.

    Returns (loss, {"xent", "moe_aux", "tokens", "moe_kept", "moe_choices"}):
    the loss is the *sum* over valid tokens divided by their count (at least
    1), plus the MoE auxiliary loss, as the reference defines it (exact under
    any task allocation); the MoE counts are :func:`forward`'s.  The final
    norm, the logits and the cross entropy run in the range
    ``repro.model.head`` (``obs.ranges``)."""
    h, metrics = _trunk(params, batch["inputs"], cfg, attn_impl)
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    with region("repro.model.head") as r:
        with _unit(params, "head"):
            logits = _logits(params, _norm(r.input(h), params.final_norm, cfg), cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        token_count = torch.clamp(mask.sum(), min=1.0)
        xent = r.output(-(ll * mask).sum() / token_count)
    loss = xent + metrics["moe_aux"]
    return loss, {"xent": xent, "tokens": token_count, **metrics}


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens (B,) -> (logits (B, V), cache).  The cache is
    updated in place (attention layers write their tensors, recurrent layers
    get new ones in their dicts) and returned with ``index + 1``; ``pages`` is
    read-only here (the engine owns it).  An MoE layer routes the B tokens as
    one group, every slot's row included, as the reference's decode does."""
    h = _embed_in(params, tokens[:, None], cfg)
    index = cache["index"]
    pages = cache.get("pages")
    for layer, layer_cache in zip(params.layers, cache["layers"]):
        if layer.spec.kind == "rwkv":
            h, new = rwkv_lib.rwkv_decode(layer.rwkv, h, layer_cache, cfg)
            layer_cache.update(new)
            continue
        hi = _norm(h, layer.norm1, cfg)
        if layer.spec.kind == "mamba":
            mix, new = mamba_lib.mamba_decode(layer.mixer, hi, layer_cache, cfg)
            layer_cache.update(new)
        else:
            c = dict(layer_cache, index=index)
            if pages is not None:
                c["pages"] = pages
            mix, _ = attn_lib.attention_decode(layer.mixer, hi, c, cfg, layer.spec.attn_type)
        h, _ = _ffn_half(layer, h, mix, cfg, moe_group=h.shape[0] * h.shape[1])
    h = _norm(h, params.final_norm, cfg)
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
    wkv_impl: str = "kernel",
    moe_metrics: list | None = None,
    moe_routes: list | None = None,
) -> tuple[torch.Tensor, dict]:
    """Batched prompt-parallel prefill: one forward over the whole padded prompt
    writes every layer's cache.

    tokens: (B, S_p) right-padded prompts, or (B, S_p, d) float embeddings
    with ``cfg.embeds_input``; lengths: (B,) valid counts (1..S_p);
    cache: a dense per-slot cache from ``init_cache`` (read for its shapes
    and dtypes, not modified).  ``attn_impl`` picks the attention layers'
    route, ``wkv_impl`` ("scan", "chunked" or "kernel") the RWKV layers'.
    The default "kernel" (``kernels.ops.rwkv6_scan``: the CUDA kernel on the
    card, the plain sequential scan on the CPU) departs from the reference's
    "chunked" so that serving on the card runs the kernel.  Recurrent layers
    (Mamba, RWKV6) freeze their state at each row's last real token; an MoE
    layer routes in groups of 2048 tokens, as the reference's prefill does.
    ``moe_metrics``, a list, receives each MoE layer's metrics dict;
    ``moe_routes``, a list of each MoE layer's expert choice in layer order
    (the metrics' ``top_idx`` of another run), routes by it in place of the
    router's top-k, which holds the routing fixed between two attention routes.
    Returns (logits at each row's last real token (B, V), a new cache with
    ``index == lengths``)."""
    h = _embed_in(params, tokens, cfg)
    lengths = lengths.to(torch.int32)
    routes = iter(moe_routes) if moe_routes is not None else None
    layers = []
    for layer, layer_cache in zip(params.layers, cache["layers"]):
        if layer.spec.kind == "rwkv":
            h, new = rwkv_lib.rwkv_prefill(layer.rwkv, h, cfg, lengths, wkv_impl)
            layers.append({key: val.to(layer_cache[key].dtype) for key, val in new.items()})
            continue
        hi = _norm(h, layer.norm1, cfg)
        if layer.spec.kind == "mamba":
            mix, new = mamba_lib.mamba_prefill(layer.mixer, hi, cfg, lengths)
            new = {key: val.to(layer_cache[key].dtype) for key, val in new.items()}
        else:
            mix, new = attn_lib.attention_prefill(
                layer.mixer, hi, layer_cache, cfg, layer.spec.attn_type, lengths, impl=attn_impl
            )
        h, _ = _ffn_half(layer, h, mix, cfg, moe_metrics=moe_metrics, moe_routes=routes)
        layers.append(new)
    h = _norm(h, params.final_norm, cfg)
    last = h[torch.arange(h.shape[0], device=h.device), lengths.long() - 1]
    return _logits(params, last, cfg), {"index": lengths, "layers": layers}
