"""The yardstick's arithmetic, frozen with the benchmark: the chip's peaks, the
model's analytic FLOPs and the operations and bytes of the kernels the cells reach.

``analytic_flops`` is a copy of ``repro_torch.analysis.costmodel.analytic_flops``
(the port's textbook count: matrix products, attention's products, the MoE's
capacity-bounded dispatch) that reads the benchmark's configuration file
instead of the program's config class; ``bench/tests/test_bench_costs.py``
holds the two equal at the cells' shapes.  Later changes to the program do not
move these numbers.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def _matmul_params(c: dict) -> tuple[int, int]:
    """(matrix parameters of the layers a token goes through, of the output head)."""
    d, ff = c["d_model"], c["d_ff"]
    q_dim, kv_dim = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    total = 0
    for _ in range(c["n_layers"]):
        if c["layer"] == "attn":
            total += d * q_dim + 2 * d * kv_dim + q_dim * d
            if not c.get("n_experts"):
                total += (3 if c.get("mlp_gated", True) else 2) * d * ff
        else:  # rwkv: r, k, v, g, o of the time mix, key/value/receptance of the channel mix
            total += 5 * d * d + 2 * d * ff + d * d
    return total, d * c["vocab_size"]


def _moe_flops(c: dict, tokens: int, group: int) -> int:
    """One MoE layer's forward over ``tokens`` in groups of ``min(group, tokens)``:
    the router's product, the dispatch and combine products, every expert over
    its whole capacity."""
    d, E, k = c["d_model"], c["n_experts"], c["top_k"]
    g = min(group, tokens)
    cap = max(int(k * g / E * c["capacity_factor"]), 1)
    cap = -(-cap // 4) * 4
    per_group = 2 * g * d * E + 2 * 2 * g * E * cap * d + E * cap * (3 if c.get("mlp_gated", True) else 2) * 2 * d * c[
        "d_ff_expert"]
    return tokens // g * per_group


def analytic_flops(c: dict, kind: str, rows: int, seq: int, remat: bool | None = None) -> int:
    """One device's model work for ``kind`` in ``("train", "prefill", "decode")``:
    ``train`` one microbatch of ``rows`` x ``seq`` (forward, backward at twice
    the forward, the layers' forward again under remat, every key block of the
    blocked attention); ``prefill`` the forward over the causal pairs; ``decode``
    one token a row against ``seq`` cached keys.  ``remat`` overrides the file's."""
    layers, head = _matmul_params(c)
    n_attn = c["n_layers"] if c["layer"] == "attn" else 0
    n_moe = c["n_layers"] if c.get("n_experts") else 0
    H, Dh = c["n_heads"], c["head_dim"]
    group = c.get("moe_group", 2048)
    if kind == "train":
        tokens = rows * seq
        fwd_layers = 2 * layers * tokens + n_attn * 4 * rows * seq * seq * H * Dh
        fwd_layers += n_moe * _moe_flops(c, tokens, group) if n_moe else 0
        remat = c.get("remat", True) if remat is None else remat
        return (3 + (1 if remat else 0)) * fwd_layers + 3 * 2 * head * tokens
    moe = n_moe * _moe_flops(c, rows * (seq if kind == "prefill" else 1), group if kind == "prefill" else rows) \
        if n_moe else 0
    if kind == "prefill":
        pairs = n_attn * (seq * (seq + 1) // 2)
        return 2 * layers * rows * seq + 4 * rows * pairs * H * Dh + 2 * head * rows + moe
    if kind == "decode":
        return 2 * (layers + head) * rows + 4 * rows * n_attn * seq * H * Dh + moe
    raise ValueError(f"unknown kind {kind!r}")


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: bytes over the HBM rate or operations
    over the peak, whichever is longer."""
    return max(nbytes / PEAK_HBM_BYTES, flops / peak_flops)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def weighted_accum_tree_cost(acc_tree, g_tree, scale, out=None) -> tuple[float, float, float]:
    """(flops, bytes, peak) of ``acc + scale * g`` over a tree: each accumulator
    read and written once, each gradient read once, a multiply and an add an
    element, in float32 outside the tensor cores."""
    flops = sum(2 * a.numel() for a in acc_tree)
    nbytes = sum(2 * _nbytes(a) + _nbytes(g) for a, g in zip(acc_tree, g_tree))
    return flops, nbytes, PEAK_F32_FLOPS


def rwkv6_scan_cost(r, k, v, w, u, s0=None, chunk=32) -> tuple[float, float, float]:
    """(flops, bytes, peak) of the WKV recurrence over (B, T, H, D) float32
    inputs: ``y = r·(S + u k v)`` and ``S = w S + k v``, six operations a
    (token, head, key, value); r, k, v, w, u and s0 read, y and the final
    state written."""
    B, T, H, D = r.shape
    flops = 6 * B * T * H * D * D
    nbytes = 4 * _nbytes(r) + _nbytes(u) + (_nbytes(s0) if s0 is not None else 0) + 4 * B * T * H * D + 4 * B * H * D * D
    return flops, nbytes, PEAK_F32_FLOPS

