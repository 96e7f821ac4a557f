"""Spec assignment for parameters, train state and decode caches.

The port of ``repro.dist.sharding``, with the reference's rules and its
divisibility gate: a dim is sharded only when the axis size divides it
exactly (smollm's 15 query heads and 5 KV heads fall back to replicated).
A spec is a plain tuple with one entry per dimension: ``None``, an axis
name, or a tuple of axis names.  Axis sizes come as a mapping
``{axis name: size}`` (``launch.mesh.axis_sizes`` of a mesh).

Layout rules (megatron-style pairing, one collective per matmul):

* column-parallel (``wq``/``wk``/``wv``/``w_gate``/``w_up``): output dim over
  ``model``;
* row-parallel (``wo``/``w_down``/``out_proj``/``value``): input dim over
  ``model``;
* ``embed`` is vocab-parallel (dim 0 over ``model``); ``lm_head`` is
  column-parallel;
* FSDP (``fsdp=True``): the matmul dim not taken by ``model`` is sharded over
  ``fsdp_axes``;
* leaves of rank < 2 in the reference's tree are replicated.

The reference stacks the repeating body's layers on a leading axis; the
port keeps one tensor per layer.  So each parameter's spec is the
reference's spec of its leaf (keyed by the leaf's name and its trailing two
dimensions, on the leaf's reference shape) with the stacking dimension left
out: a body layer's (d,) norm gain is (n_repeats, d) there, and its spec here
is that spec's last entry.
"""

from __future__ import annotations

from collections.abc import Mapping

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_ndims
from repro_torch.models.transformer import Transformer

__all__ = ["param_specs", "state_specs", "cache_specs"]

# weights whose INPUT dim is the big contracted one (row-parallel)
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "value"}


def _axes_entry(axes: tuple[str, ...]):
    return axes[0] if len(axes) == 1 else axes


def _group_size(sizes: Mapping[str, int], axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _matmul_spec(name: str, shape: tuple, sizes: Mapping[str, int], fsdp: bool, fsdp_axes: tuple[str, ...]) -> tuple:
    """The reference's ``param_specs`` rule for one leaf of ``shape``."""
    if len(shape) < 2:
        return (None,) * len(shape)
    model = sizes.get("model", 1)
    fsdp_size = _group_size(sizes, fsdp_axes)
    spec: list = [None] * len(shape)
    # the trailing two dims are the matmul (in, out); anything in front is
    # layer stacking and stays unsharded
    d_in, d_out = len(shape) - 2, len(shape) - 1
    if name == "embed" or name in _ROW_PARALLEL:
        model_dim, fsdp_dim = d_in, d_out  # vocab-parallel / row-parallel
    else:
        model_dim, fsdp_dim = d_out, d_in
    if model > 1 and shape[model_dim] % model == 0:
        spec[model_dim] = "model"
    if fsdp and fsdp_axes and fsdp_size > 1 and shape[fsdp_dim] % fsdp_size == 0:
        spec[fsdp_dim] = _axes_entry(fsdp_axes)
    return tuple(spec)


def param_specs(
    params: Transformer,
    axis_sizes: Mapping[str, int],
    cfg: ModelConfig,
    fsdp: bool = False,
    fsdp_axes: tuple[str, ...] = ("data",),
) -> list[tuple]:
    """One spec per parameter, in ``named_parameters`` order.  ``params`` may
    live on the meta device: only names and shapes are read."""
    sizes = {name: int(size) for name, size in axis_sizes.items()}
    fsdp_axes = tuple(a for a in fsdp_axes if a in sizes)
    out = []
    for (name, p), nd in zip(params.named_parameters(), reference_ndims(params, cfg), strict=True):
        stacked = nd - p.ndim  # 1 for a layer of the repeating body
        ref_shape = (cfg.n_repeats,) * stacked + tuple(p.shape)
        out.append(_matmul_spec(name.split(".")[-1], ref_shape, sizes, fsdp, fsdp_axes)[stacked:])
    return out


def state_specs(
    state: dict,
    axis_sizes: Mapping[str, int],
    cfg: ModelConfig,
    fsdp: bool = True,
    fsdp_axes: tuple[str, ...] = ("data",),
) -> dict:
    """Specs for a train state ``{"params", "opt", "step"}``.  The optimizer's
    per-parameter lists (``mu``/``nu``/``velocity``) take the parameters'
    specs, so under ``fsdp="gather"`` parameters and moments alike live at
    1/N per process and the update is elementwise on shards; scalars
    (``step``, ``count``) are replicated."""
    pspecs = param_specs(state["params"], axis_sizes, cfg, fsdp=fsdp, fsdp_axes=fsdp_axes)
    opt = {key: list(pspecs) if isinstance(val, list) else () for key, val in state["opt"].items()}
    return {"params": pspecs, "opt": opt, "step": ()}


def cache_specs(cache: dict, axis_sizes: Mapping[str, int], dp_axes: tuple[str, ...] = ("data",)) -> dict:
    """Specs for a cache from ``transformer.init_cache``, the reference's rule
    with the stacking dimension left out: dim 0 of every leaf but ``index``
    and ``pos`` (the batch, or a paged pool's pages, as the reference reads
    it) over ``dp_axes``, KV head dims over ``model``.  Same divisibility gate
    as :func:`param_specs`."""
    sizes = {name: int(size) for name, size in axis_sizes.items()}
    model = sizes.get("model", 1)
    dp_axes = tuple(a for a in dp_axes if a in sizes)
    dp_size = _group_size(sizes, dp_axes)

    def spec_for(name: str, leaf) -> tuple:
        if leaf.ndim == 0 or name in ("index", "pos"):
            return (None,) * leaf.ndim
        spec: list = [None] * leaf.ndim
        if dp_axes and dp_size > 1 and leaf.shape[0] % dp_size == 0:
            spec[0] = _axes_entry(dp_axes)
        if model > 1:
            if name in ("k", "v") and leaf.ndim >= 3 and leaf.shape[-2] % model == 0:
                spec[-2] = "model"  # (.., S, Hkv, Dh): heads
            elif name in ("k_scale", "v_scale") and leaf.ndim >= 2 and leaf.shape[-1] % model == 0:
                spec[-1] = "model"
        return tuple(spec)

    out: dict = {key: spec_for(key, val) for key, val in cache.items() if key != "layers"}
    out["layers"] = [{key: spec_for(key, val) for key, val in layer.items()} for layer in cache["layers"]]
    return out
