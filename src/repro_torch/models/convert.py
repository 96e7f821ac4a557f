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
``layers[rep].rwkv.ln1.gain``.

The tree's leaves are numpy arrays (``jax.tree.map(np.asarray, params)``);
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = ["params_from_jax", "params_to_jax"]


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
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(tree: dict, cfg: ModelConfig, device: str | torch.device = "cuda") -> Transformer:
    """The reference ``init_params`` tree (numpy leaves) as the port's parameters on ``device``."""
    state = _flatten({key: val for key, val in tree.items() if key not in ("body", "tail")})
    for n, (group, key, rep) in enumerate(_layer_slots(cfg)):
        for name, leaf in _flatten(tree[group][key]).items():
            state[f"layers.{n}.{name}"] = leaf if rep is None else np.asarray(leaf)[rep]
    model = Transformer(cfg, resolve_device(device))
    model.load_state_dict({k: _to_tensor(v) for k, v in state.items()}, strict=True)
    return model.requires_grad_(False)


def params_to_jax(params: Transformer, cfg: ModelConfig) -> dict:
    """The port's parameters as a reference-shaped tree of numpy arrays
    (bfloat16 tensors come out as float32)."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = _unflatten({name: host(p) for name, p in params.named_parameters() if not name.startswith("layers.")})
    groups: dict = {}
    for layer, (group, key, _) in zip(params.layers, _layer_slots(cfg)):
        flat = {name: host(p) for name, p in layer.named_parameters()}
        groups.setdefault(group, {}).setdefault(key, []).append(flat)
    if "body" in groups:
        tree["body"] = {
            key: _unflatten({name: np.stack([f[name] for f in reps]) for name in reps[0]})
            for key, reps in groups["body"].items()
        }
    if "tail" in groups:
        tree["tail"] = {key: _unflatten(reps[0]) for key, reps in groups["tail"].items()}
    return tree
