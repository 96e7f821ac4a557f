"""Weights made by the benchmark from ``--seed``, on the device, block by block.

A configuration's leaves (name, shape, dtype) come from its plain reference
(``ref.leaves``); the file's ``init`` rules give each leaf its draw.  A block
is the embedding, one layer, or the final norm with the output head: each
block's draws come from one ``torch.randn`` call, in bfloat16 (the type the
weights are served and trained in), from a generator on the device seeded by
(seed, block).  The program and the reference get the same values, and any
block can be made again alone (the parameter change after the compared steps
is taken against it).
"""

from __future__ import annotations

import torch

_BLOCK_SEED = 1_000_003


def _rule(conf: dict, name: str):
    for rule in conf["init"]:
        if rule[0] in name:
            return rule
    raise ValueError(f"no init rule for {name}")


def _std(conf: dict, shape: tuple, how) -> float:
    if isinstance(how, (int, float)):
        return float(how)
    if how == "fan_in":
        return shape[-2] ** -0.5
    if how == "d_model":
        return conf["d_model"] ** -0.5
    if how == "residual":
        return (shape[-2] * 2 * conf["n_layers"]) ** -0.5
    raise ValueError(f"unknown init scale {how!r}")


def block_of(name: str, n_layers: int) -> int:
    """0 for the embedding, 1 + i for layer i, n_layers + 1 for the final norm and head."""
    if name.startswith("layers."):
        return 1 + int(name.split(".")[1])
    return 0 if name == "embed" else n_layers + 1


def make_block(conf: dict, leaves: list, block: int, seed: int, device) -> dict:
    """{name: tensor} of one block's leaves, drawn as the module docstring says."""
    mine = [(n, s, dt) for n, s, dt in leaves if block_of(n, conf["n_layers"]) == block]
    drawn = [(n, s, dt) for n, s, dt in mine if _rule(conf, n)[1] == "normal"]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed((seed * _BLOCK_SEED + block) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=torch.bfloat16, device=device) if total else None
    out, at = {}, 0
    for name, shape, dtype in mine:
        rule = _rule(conf, name)
        if rule[1] == "const":
            out[name] = torch.full(shape, rule[2], dtype=dtype, device=device)
            continue
        n = torch.Size(shape).numel()
        std, mean = _std(conf, shape, rule[2]), (rule[3] if len(rule) > 3 else 0.0)
        t = flat[at:at + n].view(shape) * std
        out[name] = (t + mean if mean else t).to(dtype)
        at += n
    return out


def n_blocks(conf: dict) -> int:
    return conf["n_layers"] + 2


@torch.no_grad()
def fill_module(module: torch.nn.Module, conf: dict, leaves: list, seed: int) -> None:
    """Copy the seeded weights into a program's module, whose named parameters
    must be exactly the reference's leaves (names, shapes, dtypes)."""
    params = dict(module.named_parameters())
    want = {n: (tuple(s), dt) for n, s, dt in leaves}
    have = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the program's parameters are not the configuration's leaves: {diff}")
    device = next(iter(params.values())).device
    for b in range(n_blocks(conf)):
        for name, t in make_block(conf, leaves, b, seed, device).items():
            params[name].copy_(t)
        del t
