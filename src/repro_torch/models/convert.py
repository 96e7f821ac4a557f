"""Weight hand-over between the reference's parameter tree and the port's ``Transformer``.

Weight layout, stated once: every matrix is ``(d_in, d_out)`` on both sides
(``x @ w``), and the embedding is ``(vocab, d_model)``, so matrices are copied
as they are, with no transpose.  Names match too: the reference's
``params["body"][f"layer{i}"]["mixer"]["wq"][rep]`` is the port's
``layers[rep * pattern_len + i].mixer.wq``.  The reference stacks the
repeating pattern's layers on a leading ``n_repeats`` axis
(``jax.vmap`` over ``_init_pattern``) and keeps left-over layers unstacked
under ``params["tail"]``; the port keeps one ``Block`` per layer, in
execution order.  Nested dicts map to submodules: a LayerNorm's
``{"gain", "bias"}`` (``final_norm``, ``norm1``, an RWKV layer's ``ln1``)
becomes ``final_norm.gain``/``final_norm.bias``, and an RWKV layer's
``params["body"]["layer0"]["rwkv"]["ln1"]["gain"][rep]`` is the port's
``layers[rep].rwkv.ln1.gain``.  An MoE ffn's expert stack is (E, d_in,
d_out) on both sides, so the body's leaf is (R, E, d_in, d_out); a Mamba
mixer's leaves (``in_proj``, ``A_log``, ...) map like an attention
mixer's.  A config of fewer layers than its pattern (jamba cut to 7 of its
8-layer superblock) has no body: every layer sits in ``params["tail"]``.

The train state crosses too (``train_state_from_jax``/``train_state_to_jax``):
the optimizer's per-parameter trees (AdamW ``mu``/``nu``, SGD ``velocity``)
map like the parameters, to lists in ``named_parameters`` order, and the
counters to device scalars.  ``reference_ndims`` gives each parameter's rank
in the reference's stacked tree, which decides weight decay.

The paper's convnets cross too (``convnet_params_from_jax``/
``convnet_params_to_jax``): a convolution's HWIO kernel becomes OIHW, the
dense ``fc`` stays (d_in, n_classes), a GroupNorm's ``{"gamma", "beta"}``
becomes ``gammas.i``/``betas.i`` (VGG) or ``gn1_gamma``/``gn1_beta`` (a
ResNet block).

The tree's leaves are numpy arrays (``jax.tree.map(np.asarray, params)``);
this module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = [
    "LeafSpec",
    "convnet_params_from_jax",
    "convnet_params_to_jax",
    "params_from_jax",
    "params_to_jax",
    "reference_ndims",
    "reference_paths",
    "train_state_from_jax",
    "train_state_spec",
    "train_state_to_jax",
]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and numpy dtype, standing in for its array where only those are read."""

    shape: tuple
    dtype: np.dtype


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def _layer_slots(cfg: ModelConfig):
    """(tree group, pattern key, repeat index or None) of each layer, in execution order."""
    for rep in range(cfg.n_repeats):
        for i in range(cfg.pattern_len):
            yield "body", f"layer{i}", rep
    for i in range(len(cfg.tail_layers)):
        yield "tail", f"layer{i}", None


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy's bfloat16 (ml_dtypes) is no buffer torch reads; fp32 holds it exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: the caller's arrays (JAX's, read-only) are never written


def _named_from_tree(tree: dict, cfg: ModelConfig) -> dict:
    """{port parameter name: leaf} of a reference-shaped tree (body leaves unstacked)."""
    named = _flatten({key: val for key, val in tree.items() if key not in ("body", "tail")})
    for n, (group, key, rep) in enumerate(_layer_slots(cfg)):
        for name, leaf in _flatten(tree[group][key]).items():
            named[f"layers.{n}.{name}"] = leaf if rep is None else np.asarray(leaf)[rep]
    return named


def _tree_from_named(named: dict, cfg: ModelConfig, stack=np.stack) -> dict:
    """The inverse of ``_named_from_tree``: a reference-shaped tree, body layers
    stacked by ``stack`` (a list of the repeats' leaves -> one leaf)."""
    tree = _unflatten({name: leaf for name, leaf in named.items() if not name.startswith("layers.")})
    groups: dict = {}
    for n, (group, key, _) in enumerate(_layer_slots(cfg)):
        prefix = f"layers.{n}."
        flat = {name[len(prefix):]: leaf for name, leaf in named.items() if name.startswith(prefix)}
        groups.setdefault(group, {}).setdefault(key, []).append(flat)
    if "body" in groups:
        tree["body"] = {
            key: _unflatten({name: stack([f[name] for f in reps]) for name in reps[0]})
            for key, reps in groups["body"].items()
        }
    if "tail" in groups:
        tree["tail"] = {key: _unflatten(reps[0]) for key, reps in groups["tail"].items()}
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(tree: dict, cfg: ModelConfig, device: str | torch.device = "cuda") -> Transformer:
    """The reference ``init_params`` tree (numpy leaves) as the port's parameters on ``device``."""
    model = Transformer(cfg, resolve_device(device))
    model.load_state_dict({k: _to_tensor(v) for k, v in _named_from_tree(tree, cfg).items()}, strict=True)
    return model.requires_grad_(False)


def params_to_jax(params: Transformer, cfg: ModelConfig) -> dict:
    """The port's parameters as a reference-shaped tree of numpy arrays
    (bfloat16 tensors come out as float32)."""
    return _tree_from_named({name: _host(p) for name, p in params.named_parameters()}, cfg)


def reference_ndims(params: Transformer, cfg: ModelConfig) -> list[int]:
    """Each parameter's rank in the reference's tree, in ``named_parameters``
    order: a layer of the repeating body is stacked there on a leading axis
    (one more dimension), a tail layer and the top-level leaves are not.
    The optimizers decide weight decay by this rank (``optim.adamw``)."""
    body = {n for n, (group, _, _) in enumerate(_layer_slots(cfg)) if group == "body"}
    return [
        p.ndim + (name.startswith("layers.") and int(name.split(".")[1]) in body)
        for name, p in params.named_parameters()
    ]


def reference_paths(params: Transformer, cfg: ModelConfig) -> list[str]:
    """Each parameter's leaf in the reference's tree as ``jax.tree_util.keystr``
    writes it, in ``named_parameters`` order; a layer of the repeating body
    adds its index into the stacked leaf (``layers.3.mixer.wq`` of a
    one-layer pattern is ``['body']['layer0']['mixer']['wq'][3]``).  The
    collectives name a parameter by it in their errors."""
    slots = list(_layer_slots(cfg))
    out = []
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            out.append("".join(f"[{p!r}]" for p in parts))
            continue
        group, key, rep = slots[int(parts[1])]
        path = "".join(f"[{p!r}]" for p in (group, key, *parts[2:]))
        out.append(path if rep is None else f"{path}[{rep}]")
    return out


def train_state_from_jax(state: dict, cfg: ModelConfig, device: str | torch.device = "cuda") -> dict:
    """The reference's ``{"params", "opt", "step"}`` train state (numpy leaves)
    as the port's: the parameters as a ``Transformer`` that requires grad, the
    optimizer's per-parameter trees (AdamW ``mu``/``nu``, SGD ``velocity``) as
    lists in ``named_parameters`` order, and the counters as device scalars."""
    dev = resolve_device(device)
    params = params_from_jax(state["params"], cfg, dev).requires_grad_(True)
    names = [name for name, _ in params.named_parameters()]
    opt: dict = {}
    for key, val in state["opt"].items():
        if isinstance(val, dict):
            named = _named_from_tree(val, cfg)
            opt[key] = [_to_tensor(named[name]).to(dev) for name in names]
        else:
            opt[key] = torch.tensor(np.asarray(val), dtype=torch.int32, device=dev)
    step = torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=dev)
    return {"params": params, "opt": opt, "step": step}


def train_state_to_jax(state: dict, cfg: ModelConfig) -> dict:
    """The port's train state as a reference-shaped tree of numpy arrays
    (bfloat16 tensors come out as float32)."""
    names = [name for name, _ in state["params"].named_parameters()]
    opt = {
        key: _tree_from_named(dict(zip(names, (_host(t) for t in val), strict=True)), cfg)
        if isinstance(val, list)
        else _host(val)
        for key, val in state["opt"].items()
    }
    return {"params": params_to_jax(state["params"], cfg), "opt": opt, "step": _host(state["step"])}


def _spec(t: torch.Tensor) -> LeafSpec:
    host = torch.float32 if t.dtype == torch.bfloat16 else t.dtype  # as ``_host`` gives it
    return LeafSpec(tuple(t.shape), torch.empty((), dtype=host).numpy().dtype)


def _stack_specs(specs: list) -> LeafSpec:
    return LeafSpec((len(specs), *specs[0].shape), specs[0].dtype)


def train_state_spec(state: dict, cfg: ModelConfig) -> dict:
    """``train_state_to_jax``'s tree with a :class:`LeafSpec` for each array:
    the ``like`` tree of a checkpoint restore, built without copying the
    state off the device."""
    names = [name for name, _ in state["params"].named_parameters()]

    def tree(tensors) -> dict:
        return _tree_from_named({n: _spec(t) for n, t in zip(names, tensors, strict=True)}, cfg, _stack_specs)

    opt = {key: tree(val) if isinstance(val, list) else _spec(val) for key, val in state["opt"].items()}
    return {"params": tree(state["params"].parameters()), "opt": opt, "step": _spec(state["step"])}


# ---------------------------------------------------------------------------
# the paper's convnets (models.convnet)
# ---------------------------------------------------------------------------


def _convnet_names(arch: str, tree: dict) -> list[tuple[str, tuple, bool]]:
    """(state-dict name, tree path, is a conv kernel) of every leaf of a
    reference convnet tree, ``arch`` one of ``convnet.CONVNET_ARCHS``."""
    if arch == "convnet":
        return [("c1", ("c1",), True), ("c2", ("c2",), True), ("fc", ("fc",), False)]
    if arch.startswith("vgg"):
        out = []
        for i in range(len(tree["convs"])):
            out += [(f"convs.{i}", ("convs", i), True), (f"gammas.{i}", ("gns", i, "gamma"), False),
                    (f"betas.{i}", ("gns", i, "beta"), False)]
        return out + [("fc", ("fc",), False)]
    if arch.startswith("resnet"):
        out = [("stem", ("stem",), True)]
        for i, blk in enumerate(tree["blocks"]):
            out += [(f"blocks.{i}.c1", ("blocks", i, "c1"), True), (f"blocks.{i}.c2", ("blocks", i, "c2"), True)]
            for g in ("gn1", "gn2"):
                out += [(f"blocks.{i}.{g}_{k}", ("blocks", i, g, k), False) for k in ("gamma", "beta")]
            if "proj" in blk:
                out.append((f"blocks.{i}.proj", ("blocks", i, "proj"), True))
        return out + [("fc", ("fc",), False)]
    raise ValueError(f"unknown convnet arch {arch!r}")


def convnet_params_from_jax(tree: dict, arch: str) -> dict[str, torch.Tensor]:
    """The reference's convnet tree (numpy leaves) as a ``state_dict`` of the
    port's model of ``arch``: HWIO kernels to OIHW, the rest as they are."""
    out = {}
    for name, path, conv in _convnet_names(arch, tree):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        a = np.asarray(leaf, np.float32)
        out[name] = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if conv else a, copy=True, order="C"))
    return out


def convnet_params_to_jax(state: dict, arch: str) -> dict:
    """The inverse of :func:`convnet_params_from_jax`: a port model's
    ``state_dict`` (any device) as the reference's tree of numpy arrays."""
    state = {k: v.detach().cpu().numpy() for k, v in state.items()}
    if arch == "convnet":
        tree: dict = {}
    elif arch.startswith("vgg"):
        n = sum(1 for k in state if k.startswith("convs."))
        tree = {"convs": [None] * n, "gns": [{} for _ in range(n)]}
    elif arch.startswith("resnet"):
        n = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
        tree = {"blocks": [{"gn1": {}, "gn2": {}} for _ in range(n)]}
        for i in range(n):
            if f"blocks.{i}.proj" in state:
                tree["blocks"][i]["proj"] = None
    else:
        raise ValueError(f"unknown convnet arch {arch!r}")
    names = _convnet_names(arch, tree)
    if {n for n, _, _ in names} != set(state):
        raise ValueError(f"state_dict keys {sorted(state)} are not a {arch} model's")
    for name, path, conv in names:
        node = tree
        for k in path[:-1]:
            node = node[k]
        a = state[name]
        node[path[-1]] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if conv else a
    return tree
