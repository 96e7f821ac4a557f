"""FLOP and byte counts of a run on meta tensors, and the analytic figure they are held to.

The port of ``repro.analysis.costmodel``.  :func:`estimate_cost` runs a
function (on meta tensors: shapes only, nothing computed) and counts

* ``flops``: the matrix products' FLOPs as ``torch.utils.flop_counter``
  counts them (``2 * M * N * K`` a product, backward included), plus the
  operations the CUDA kernels would do on the meta route, where they run
  nothing (``KERNEL_FLOPS``: one formula a kernel, counted by wrapping the
  four ``kernels.ops`` entry points while the function runs);
* ``bytes``: each dispatched operation's operand and result bytes, the
  views and copies of ``_FREE_OPS`` left out, an un-fused upper bound.

Departure from the reference: the reference counts a loop body once, as
XLA's ``cost_analysis`` does, and holds its figure to XLA's.  The port runs
eagerly and counts every layer, microbatch and block, so the dry run holds
the count to :func:`analytic_flops` instead and warns outside a 2x band.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

__all__ = ["KERNEL_FLOPS", "analytic_flops", "estimate_cost", "per_device"]

aten = torch.ops.aten
# operations that move or alias data at no arithmetic cost (the reference's _FREE_PRIMS)
_FREE_OPS = {
    aten.view.default, aten._unsafe_view.default, aten.reshape.default, aten.expand.default,
    aten.permute.default, aten.transpose.int, aten.t.default, aten.squeeze.dim, aten.squeeze.dims,
    aten.unsqueeze.default, aten.slice.Tensor, aten.select.int, aten.alias.default, aten.detach.default,
    aten._to_copy.default, aten.clone.default, aten.copy_.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.split.Tensor, aten.split_with_sizes.default, aten.unbind.int,
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _ByteCounter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _FREE_OPS:
            ins, _ = tree_flatten((args, kwargs or {}))
            outs, _ = tree_flatten(out)
            self.bytes += sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        return out


def _reach_pairs(Sq: int, Sk: int, causal: bool, window: int | None, q_offset: int) -> int:
    """(query, key) pairs within reach: key <= query + q_offset when causal,
    and within ``window`` of it."""
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_flops(q, k, v, q_pos=None, k_pos=None, *, causal=True, window=None, softcap=0.0, q_offset=0):
    B, Sq, H, Dh = q.shape  # QK^T and PV over the pairs in reach, multiply and add
    return 4 * B * H * Dh * _reach_pairs(Sq, k.shape[1], causal, window, q_offset)


def _paged_flops(q, k_pool, v_pool, pages, lengths, k_scale=None, v_scale=None, *, window=None, softcap=0.0):
    B, H, Dh = q.shape  # every page-table slot: the lengths are not known on meta
    return 4 * B * H * Dh * pages.shape[1] * k_pool.shape[1]


def _rwkv_flops(r, k, v, w, u, s0=None, chunk=32):
    B, T, H, D = r.shape  # y = r·(S + u k v) and S = w S + k v
    return 6 * B * T * H * D * D


def _accum_flops(acc, g, scale, out=None):
    return 2 * acc.numel()


# the operations each kernel does on its inputs, by ``kernels.ops`` entry point (same signatures)
KERNEL_FLOPS = {
    "flash_attention": _flash_flops,
    "paged_attention": _paged_flops,
    "rwkv6_scan": _rwkv_flops,
    "weighted_accum": _accum_flops,  # weighted_accum_tree calls it once a tensor on meta
}


@contextlib.contextmanager
def _counting_kernels(counts: dict):
    """While open, each ``kernels.ops`` entry point called on meta tensors adds
    its ``KERNEL_FLOPS`` to ``counts[name]``; the entry points are restored on exit."""
    saved = {name: getattr(kops, name) for name in KERNEL_FLOPS}

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if args[0].device.type == "meta":
                counts[name] += KERNEL_FLOPS[name](*args, **kwargs)
            return fn(*args, **kwargs)

        return call

    try:
        for name, fn in saved.items():
            setattr(kops, name, counted(name, fn))
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def estimate_cost(fn, *args, **kwargs) -> dict:
    """``{"flops", "bytes", "kernel_flops", "result"}`` of one call ``fn(*args, **kwargs)``."""
    kernel = dict.fromkeys(KERNEL_FLOPS, 0)
    with _counting_kernels(kernel), FlopCounterMode(display=False) as fc, _ByteCounter() as bc:
        result = fn(*args, **kwargs)
    return {"flops": int(fc.get_total_flops()) + sum(kernel.values()), "bytes": int(bc.bytes),
            "kernel_flops": {k: v for k, v in kernel.items() if v}, "result": result}


def per_device(est: dict, n_devices: int) -> dict:
    """``{"flops", "bytes"}`` of a count over the whole mesh, per device."""
    n = max(int(n_devices), 1)
    return {"flops": est["flops"] / n, "bytes": est["bytes"] / n}


def _matmul_params(cfg: ModelConfig) -> tuple[int, int]:
    """(matrix parameters of the layers a token goes through, of the output
    head): attention projections, the dense MLP, Mamba's and RWKV6's
    projections (an MoE ffn is :func:`_moe_flops`'s).  Vectors (norms,
    biases, decays) and the embedding lookup do no product."""
    d, ff = cfg.d_model, cfg.d_ff
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    mlp = (3 if cfg.mlp_gated else 2) * d * ff
    total = 0
    for spec in cfg.layer_specs():
        if spec.kind == "attn":
            total += attn
        elif spec.kind == "mamba":
            m = cfg.mamba
            dtr = m.resolved_dt_rank(d)
            total += d * 2 * m.d_inner + m.d_inner * (dtr + 2 * m.d_state) + dtr * m.d_inner + m.d_inner * d
        else:  # rwkv: r, k, v, g, o of time mix, key/value/receptance of channel mix
            total += 5 * d * d + 2 * d * cfg.d_ff + d * d
        if spec.kind != "rwkv" and not spec.moe:
            total += mlp
    return total, d * cfg.vocab_size


def _moe_flops(cfg: ModelConfig, tokens: int, group: int) -> int:
    """One MoE layer's forward over ``tokens`` in groups of ``min(group,
    tokens)`` (``models.moe.moe_apply``): the router's product, the
    (tokens, experts, capacity) dispatch and combine products, and every
    expert over its whole capacity."""
    mo, d = cfg.moe, cfg.d_model
    g = min(group, tokens)
    E = mo.n_experts
    cap = max(int(mo.top_k * g / E * mo.capacity_factor), 1)
    cap = -(-cap // 4) * 4
    per_group = 2 * g * d * E + 2 * 2 * g * E * cap * d + E * cap * (3 if cfg.mlp_gated else 2) * 2 * d * mo.d_ff_expert
    return tokens // g * per_group


def analytic_flops(cfg: ModelConfig, kind: str, rows: int, seq: int) -> int:
    """The textbook count of one device's model work: ``2·N`` FLOPs a token
    for N matrix parameters (``_matmul_params``), plus attention's products
    (``QK^T`` and ``PV``, ``4·S_q·S_k·H·Dh`` a sequence and layer).

    * ``train`` (one microbatch of ``rows`` x ``seq``): forward, backward at
      twice the forward, and the layers' forward again under ``cfg.remat``
      (each layer is recomputed in its backward); the port's blocked
      attention computes every key block, so no causal halving.
    * ``prefill``: the forward, attention over the causal pairs only (the
      flash kernel skips blocks above the diagonal: ``S(S+1)/2`` a head,
      fewer within a local layer's window).
    * ``decode``: one token against ``seq`` cached keys (a windowed cache's
      local layer: the window's).

    An MoE ffn counts its capacity-bounded dispatch (:func:`_moe_flops`):
    groups of 2048 tokens in training and prefill, every row as one group
    in decode, as ``models.transformer`` routes them."""
    layers, head = _matmul_params(cfg)
    attn = [s for s in cfg.layer_specs() if s.kind == "attn"]
    n_attn = len(attn)
    n_moe = sum(1 for s in cfg.layer_specs() if s.moe)
    H, Dh = cfg.n_heads, cfg.head_dim

    def window(spec) -> int:
        return cfg.sliding_window if spec.attn_type == "local" else seq

    if kind == "train":
        tokens = rows * seq
        fwd_layers = 2 * layers * tokens + n_attn * 4 * rows * seq * seq * H * Dh
        fwd_layers += n_moe * _moe_flops(cfg, tokens, 2048) if n_moe else 0
        remat = 1 if cfg.remat and cfg.remat_policy != "none" else 0
        return (3 + remat) * fwd_layers + 3 * 2 * head * tokens
    moe = n_moe * _moe_flops(cfg, rows * (seq if kind == "prefill" else 1), 2048 if kind == "prefill" else rows) \
        if n_moe else 0
    if kind == "prefill":  # query q reaches min(q + 1, window) keys
        pairs = sum(sum(min(q + 1, window(s)) for q in range(seq)) if window(s) < seq else seq * (seq + 1) // 2
                    for s in attn)
        return 2 * layers * rows * seq + 4 * rows * pairs * H * Dh + 2 * head * rows + moe
    # decode: every key of the cache, a windowed cache holding only the window
    keys = sum(min(seq, cfg.sliding_window) if cfg.windowed_cache and s.attn_type == "local" else seq for s in attn)
    return 2 * (layers + head) * rows + 4 * rows * keys * H * Dh + moe
