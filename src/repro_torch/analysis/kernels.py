"""Host-side audit of each CUDA kernel's launch: grid, block, shared memory and the blocks' reads.

The counterpart of ``repro.analysis.kernels`` (which evaluates Pallas
BlockSpec index maps).  A CUDA kernel has no index map to trace, so each
launcher's arithmetic is mirrored here in Python, from the sources:

* ``flash_attention.cu`` ``launch_f32``/``launch_bf16`` (grid, block, shared
  memory) and each block's query tile and key-tile range (``k_begin``,
  ``k_end``, ``t_begin``, ``t_end``);
* ``paged_attention.cu`` ``launch`` (one block per slot, kv head and split,
  the ``Smem`` layout) and each split's live pages, with the pool row a page
  id names (``min(id, n_pages)``: an id past the pool reads the scratch
  page; an id below 0 is dead and read as zeros);
* ``rwkv6_scan.cu`` ``launch`` (``B·H·D/EC`` blocks of 256 threads,
  ``Layout<D>::BYTES``) and each block's value columns and chunks;
* ``weighted_accum.cu`` ``launch`` (one block per chunk of the planner's
  table, ``kernels.weighted_accum.plan_tree``) and each chunk's elements.

Three checks per launch, the reference's three:

* **block origins in bounds** (``kernel-oob-block``): every origin a block
  reads or writes lies inside its tensor, over the whole grid (enumerated
  up to 4096 blocks, the grid's edges sampled beyond; the kernels mask the
  rows of a tile past a tensor's end, so a tile's origin is what must lie
  inside);
* **sentinel intent** for ``paged_attention`` (``kernel-sentinel-leak``,
  ``kernel-sentinel-miss``): a live page table never reaches the scratch
  page, a table of ids past the pool always does, and a dead id is never
  read;
* **shared memory** a block (``kernel-smem-budget``), static plus dynamic,
  against sm_90's 227 KB opt-in limit (the reference's 16 MiB VMEM budget).

A mirror can drift from its ``.cu``: on the card, ``chip_smoke.py`` holds
:func:`flash_launch` and the others to the grid, block and shared memory
that torch.profiler records for each launch.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections.abc import Callable, Iterable

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.paged_attention import live_splits, plan_splits
from repro_torch.kernels.rwkv6_scan import chunk_for
from repro_torch.kernels.weighted_accum import CHUNK_VECS, ELEM_BYTES, chunk_spans, plan_tree

__all__ = [
    "SMEM_BUDGET",
    "KernelLaunch",
    "accum_launches",
    "audit_launch",
    "audit_paged_sentinel",
    "flash_launch",
    "model_cases",
    "paged_launch",
    "rwkv_launch",
]

SMEM_BUDGET = 232448  # bytes of shared memory a block may opt into on sm_90 (227 KB)
_GRID_ENUM_CAP = 4096  # full-enumeration limit; beyond it, the grid's edges are sampled

# csrc/flash_attention.cu
FLASH_THREADS = 128
FLASH_DPT = 16  # head dims of one thread, float32 route
FLASH_BQ = FLASH_BK = 64  # bfloat16 route: query rows of a block, keys of a tile
# csrc/paged_attention.cu
PAGED_THREADS = 128
# csrc/rwkv6_scan.cu
RWKV_THREADS, RWKV_CMAX, RWKV_EC, RWKV_NWARP = 256, 32, 16, 8
# csrc/weighted_accum.cu
ACCUM_THREADS = 256


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One launch as its launcher makes it.  ``reads(block)`` yields
    ``(tensor, origin)`` for every tile a block at grid index ``block``
    (x, y, z) reads or writes; ``extents`` gives each tensor's shape."""

    kernel: str
    grid: tuple
    block: tuple
    smem_dynamic: int
    smem_static: int
    extents: dict
    reads: Callable[[tuple], Iterable[tuple[str, tuple]]]

    @property
    def smem(self) -> int:
        return self.smem_dynamic + self.smem_static

    def geometry(self) -> dict:
        """What the card's profiler records of the launch."""
        return {"grid": list(self.grid), "block": list(self.block), "shared_memory": self.smem}


# ---------------------------------------------------------------------------
# the launchers' arithmetic
# ---------------------------------------------------------------------------


def flash_launch(B, Sq, Sk, H, Hkv, Dh, dtype: str = "bfloat16", causal=True, window=None, q_offset=0) -> KernelLaunch:
    """``flash_attention_fwd``: the float32 route's ``ROWS`` query rows and
    ``4096 / Dh`` keys a tile (static shared K and V tiles), or the bf16
    route's 64-row tiles (five tiles of dynamic shared memory, the query tile
    and two stages of K and V, plus 1024 bytes to align), longest tiles first."""
    window = window or 0
    if dtype == "float32":
        rows, bk = FLASH_THREADS // (Dh // FLASH_DPT), 4096 // Dh
        smem_dyn, smem_static = 0, 2 * bk * Dh * 4
    else:
        rows, bk = FLASH_BQ, FLASH_BK
        smem_dyn, smem_static = 5 * 64 * Dh * 2 + 1024, 0
    gx = -(-Sq // rows)

    def reads(idx):
        x, y, _ = idx
        q0 = (gx - 1 - x) * rows if dtype != "float32" else x * rows
        b, h = y // H, y % H
        hk = h // (H // Hkv)
        yield "q", (b, q0, h, 0)
        yield "out", (b, q0, h, 0)
        first_q = q_offset + q0
        last_q = q_offset + min(q0 + rows, Sq) - 1
        k_end = min(Sk, last_q + 1) if causal else Sk
        k_begin = max(0, first_q - window + 1) if window > 0 else 0
        t_begin = k_begin // bk
        if dtype == "float32":
            t_end = -(-k_end // bk) if k_end > 0 else 0
        else:
            t_end = -(-k_end // bk) if k_end > k_begin else t_begin
        for t in range(t_begin, t_end):
            yield "k", (b, t * bk, hk, 0)
            yield "v", (b, t * bk, hk, 0)

    return KernelLaunch("flash_attention", (gx, B * H, 1), (FLASH_THREADS, 1, 1), smem_dyn, smem_static,
                        {"q": (B, Sq, H, Dh), "out": (B, Sq, H, Dh), "k": (B, Sk, Hkv, Dh), "v": (B, Sk, Hkv, Dh)},
                        reads)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def paged_smem(row_bytes: int, G: int, Dh: int, tile: int, n_splits: int) -> int:
    """``struct Smem``'s ``bytes``: K and V tiles (rows padded by 16 bytes) or
    the merge's per-split m and l, then q, acc, scores, m, l, corr, the int8
    scales, the live flags and the source rows."""
    rs = row_bytes + 16
    tiles_end = 2 * _align16(tile * rs)
    q = max(tiles_end, _align16(2 * n_splits * G * 4))
    acc = q + _align16(G * Dh * 4)
    s = acc + _align16(G * Dh * 4)
    m = s + _align16(G * tile * 4)
    ksc = m + 3 * _align16(G * 4)
    src = ksc + 3 * _align16(tile * 4)
    return src + tile * 8


def paged_launch(lengths, table, n_pages_p1: int, page_size: int, H: int, Hkv: int, Dh: int, kv_bytes: int = 2,
                 window=None) -> KernelLaunch:
    """``paged_attention_fwd`` for a page table ``table`` (B, P) and
    ``lengths`` (B,): the split plan of ``kernels.paged_attention``, the
    ``Smem`` bytes, and each live split's page reads (the kernel reads
    ``min(id, n_pages)`` for an id >= 0 and nothing for an id < 0)."""
    table = np.asarray(table, np.int64)
    B, P = table.shape
    G = H // Hkv
    plan = plan_splits(B, Hkv, G, P, page_size, Dh, kv_bytes)
    pps, n_splits = plan.pages_per_split, plan.n_splits
    state = G * (Dh + 2)

    def reads(idx):
        x = idx[0]
        split, bh = x % n_splits, x // n_splits
        b, hk = bh // Hkv, bh % Hkv
        yield "q", (b, hk * G, 0)
        yield "out", (b, hk * G, 0)
        yield "tickets", (bh,)
        length = int(lengths[b])
        live = live_splits(length, window, P, page_size, pps)
        if split not in live:
            return
        yield "scratch", ((bh * n_splits + split) * state,)
        j_lo = max(0, length - window) // page_size if window else 0
        j_hi = min(P, -(-max(length, 0) // page_size))
        for j in range(max(split * pps, j_lo), min((split + 1) * pps, j_hi)):
            pg = int(table[b, j])
            if pg >= 0:
                yield "pool", (min(pg, n_pages_p1 - 1), 0, hk, 0)

    return KernelLaunch(
        "paged_attention", (plan.blocks, 1, 1), (PAGED_THREADS, 1, 1),
        # static: the merge's 4-byte `last` flag, which the card reports as 16 bytes (static shared memory
        # is laid out in 16-byte units; a torch.profiler reading on the H100)
        paged_smem(Dh * kv_bytes, G, Dh, plan.tile_tokens, n_splits), 16,
        {"q": (B, H, Dh), "out": (B, H, Dh), "tickets": (plan.tickets,), "scratch": (plan.scratch_floats,),
         "pool": (n_pages_p1, page_size, Hkv, Dh)},
        reads,
    )


def rwkv_smem(D: int) -> int:
    """``Layout<D>::BYTES``: two stages of r, k, w chunk tiles (rows padded by
    4 floats) and v's block columns, r e^Lprev, two state slices, the scores,
    the decays' ends, u, and the bonus' partial sums."""
    tile = RWKV_CMAX * (D + 4)
    stage = 3 * tile + RWKV_CMAX * RWKV_EC
    floats = 2 * stage + tile + 2 * D * RWKV_EC + RWKV_CMAX * (RWKV_CMAX + 1) + 2 * D + RWKV_NWARP * RWKV_CMAX
    return 4 * floats


def rwkv_launch(B: int, T: int, H: int, D: int, chunk: int = 32) -> KernelLaunch:
    """``rwkv6_scan_fwd``: one block of 256 threads per (batch, head, EC = 16
    value columns), walking the sequence in chunks of ``min(chunk, T)``."""
    c = chunk_for(T, chunk)
    ncb = D // RWKV_EC

    def reads(idx):
        x = idx[0]
        bh, e0 = x // ncb, (x % ncb) * RWKV_EC
        b, h = bh // H, bh % H
        yield "state", (b, h, 0, e0)
        for c0 in range(0, T, c):
            for name in ("r", "k", "w", "y"):
                yield name, (b, c0, h, 0)
            yield "v", (b, c0, h, e0)

    ext = {name: (B, T, H, D) for name in ("r", "k", "v", "w", "y")}
    ext["state"] = (B, H, D, D)
    return KernelLaunch("rwkv6_scan", (B * H * ncb, 1, 1), (RWKV_THREADS, 1, 1), rwkv_smem(D), 0, ext, reads)


def accum_launches(numels, acc_codes=None, g_codes=None, acc_addrs=None, g_addrs=None,
                   out_addrs=None) -> list[KernelLaunch]:
    """``weighted_accum_tree_fwd``'s launches for a tree: one per table of
    ``plan_tree``, one block per chunk (``chunk_start[count]`` blocks), each
    chunk's elements by ``chunk_spans``.  Addresses default to 256-byte
    aligned tensors (every head 0)."""
    k = len(numels)
    acc_codes = [0] * k if acc_codes is None else acc_codes
    g_codes = [0] * k if g_codes is None else g_codes
    zeros = [0] * k
    out = []
    for launch in plan_tree(numels, acc_codes, g_codes, acc_addrs or zeros, g_addrs or zeros, out_addrs or zeros):
        starts = launch.chunk_start
        width = 16 // ELEM_BYTES[launch.acc_code]
        idx = [int(i) for i in launch.index]

        def reads(block, starts=starts, idx=idx, head=launch.head, width=width):
            c = block[0]
            i = int(np.searchsorted(starts, c, side="right")) - 1
            j, n = c - int(starts[i]), int(numels[idx[i]])
            scal, vec = chunk_spans(n, int(head[i]), j, c + 1 == int(starts[i + 1]), width, CHUNK_VECS)
            for lo, hi in scal + ([vec] if vec else []):
                if hi > lo:
                    yield f"tensor{idx[i]}", (lo,)

        ext = {f"tensor{i}": (int(numels[i]),) for i in idx}
        out.append(KernelLaunch("weighted_accum", (int(starts[-1]), 1, 1), (ACCUM_THREADS, 1, 1), 0, 0, ext, reads))
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _grid_points(grid: tuple) -> tuple[list[tuple], bool]:
    sizes = [int(g) for g in grid]
    if math.prod(sizes) <= _GRID_ENUM_CAP:
        return list(itertools.product(*[range(s) for s in sizes])), False
    per_dim = [sorted({0, 1, s // 2, s - 2, s - 1} & set(range(s))) for s in sizes]
    return list(itertools.product(*per_dim)), True


def audit_launch(launch: KernelLaunch, target: str, *, smem_budget: int = SMEM_BUDGET) -> tuple[list[Finding], dict]:
    """Audit one launch: every block's origins in bounds, shared memory in budget."""
    findings: list[Finding] = []
    if launch.smem > smem_budget:
        findings.append(Finding(
            rule="kernel-smem-budget", severity="error", target=target, path=launch.kernel,
            message=(f"{launch.smem} B of shared memory a block ({launch.smem_dynamic} B dynamic + "
                     f"{launch.smem_static} B static) exceeds the budget {smem_budget} B"),
        ))
    points, sampled = _grid_points(launch.grid)
    n_origins = 0
    flagged: set = set()
    for idx in points:
        for name, origin in launch.reads(idx):
            n_origins += 1
            ext = launch.extents[name]
            bad = next((d for d, (o, e) in enumerate(zip(origin, ext)) if not 0 <= o < e), None)
            if bad is not None and name not in flagged:  # one finding per tensor, first offender
                flagged.add(name)
                findings.append(Finding(
                    rule="kernel-oob-block", severity="error", target=target, path=f"{launch.kernel}[{name}]",
                    message=(f"block {idx} reads {name} at origin {origin}; dim {bad} origin "
                             f"{origin[bad]} is outside [0, {ext[bad]})"),
                ))
    meta = dict(launch.geometry(), smem_dynamic=launch.smem_dynamic, smem_static=launch.smem_static,
                smem_budget=smem_budget, grid_points_checked=len(points), grid_sampled=sampled,
                n_origin_evals=n_origins)
    return findings, meta


def _pool_rows(launch: KernelLaunch) -> list[int]:
    rows = []
    for idx in _grid_points(launch.grid)[0]:
        rows += [origin[0] for name, origin in launch.reads(idx) if name == "pool"]
    return rows


def audit_paged_sentinel(lengths, live_table, page_size: int, n_pages: int, H: int, Hkv: int, Dh: int, target: str,
                         *, reserved: int | None = None, kv_bytes: int = 2, window=None) -> tuple[list[Finding], dict]:
    """The scratch page's intent (``reserved``, default ``n_pages``, the
    pool's last page): ``live_table`` (ids in [0, n_pages)) never reaches it,
    the same table with every id past the pool always does, and with every
    id -1 (dead) no page is read."""
    reserved = n_pages if reserved is None else reserved
    live_table = np.asarray(live_table, np.int64)
    kw = dict(n_pages_p1=n_pages + 1, page_size=page_size, H=H, Hkv=Hkv, Dh=Dh, kv_bytes=kv_bytes, window=window)
    live = _pool_rows(paged_launch(lengths, live_table, **kw))
    past = _pool_rows(paged_launch(lengths, live_table + n_pages + 1, **kw))
    dead = _pool_rows(paged_launch(lengths, np.full_like(live_table, -1), **kw))
    findings = []
    if reserved in live:
        findings.append(Finding(
            rule="kernel-sentinel-leak", severity="error", target=target, path="paged_attention[pool]",
            message=(f"the reserved page {reserved} is read under a live page table — the clamp would "
                     "silently swallow a live page"),
        ))
    if not past or any(r != reserved for r in past) or dead:
        findings.append(Finding(
            rule="kernel-sentinel-miss", severity="error", target=target, path="paged_attention[pool]",
            message=(f"ids past the pool read pages {sorted(set(past))}, not only the reserved page "
                     f"{reserved}, or dead ids read {len(dead)} pages — dead entries would read live data"),
        ))
    return findings, {"live_reads": len(live), "past_pool_reads": len(past), "dead_reads": len(dead),
                      "reserved": reserved}


# ---------------------------------------------------------------------------
# the shapes the models run
# ---------------------------------------------------------------------------

SERVE_LENGTHS = (300, 17, 160, 64)  # chip_smoke.py's smollm serving lengths, mid-generation
PAGE_SIZES = (16, 4, 2)


def _attention_shapes(cfg) -> list[tuple]:
    windows = {None}
    if any(s.kind == "attn" and s.attn_type == "local" for s in cfg.layer_specs()):
        windows.add(cfg.sliding_window)
    return [(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, w) for w in sorted(windows, key=lambda w: w or 0)]


def model_cases() -> dict[str, KernelLaunch]:
    """Every launch shape the models run: each arch's heads (and the smoke
    configs', float32 at head dim 16) through flash at prompts of 16, 256 and
    2048 tokens and through paged decode at pages of 16, 4 and 2 (int8 pools
    where the config quantizes its cache), rwkv6-1.6b's scan at its prefill
    buckets, and the accumulation trees of smollm-360m and rwkv6-1.6b."""
    import torch

    from repro_torch.configs import get_config, list_archs, smoke_config
    from repro_torch.models import transformer

    cases: dict[str, KernelLaunch] = {}
    for arch in list_archs():
        for label, cfg, dtypes in ((arch, get_config(arch), ("bfloat16",)),
                                   (f"{arch} smoke", smoke_config(arch), ("float32", "bfloat16"))):
            if not any(s.kind == "attn" for s in cfg.layer_specs()):
                continue
            for H, Hkv, Dh, window in _attention_shapes(cfg):
                for dtype in dtypes:
                    for S in (16, 256, 2048):
                        cases[f"flash {label} {dtype} S={S} window={window}"] = flash_launch(
                            1, S, S, H, Hkv, Dh, dtype, window=window)
                    kv_bytes = 1 if cfg.kv_cache_dtype == "int8" else (4 if dtype == "float32" else 2)
                    for page in PAGE_SIZES:
                        n = [-(-x // page) for x in SERVE_LENGTHS]
                        P = max(n) + 2
                        table = np.full((len(n), P), -1, np.int64)
                        start = 0
                        for b, k in enumerate(n):
                            table[b, :k] = np.arange(start, start + k)
                            start += k
                        cases[f"paged {label} {dtype} page={page} window={window}"] = paged_launch(
                            SERVE_LENGTHS, table, start + 1, page, H, Hkv, Dh, kv_bytes, window)
    for label, cfg, T_all in (("rwkv6-1.6b", get_config("rwkv6-1.6b"), (8, 16, 256)),
                              ("rwkv6-1.6b smoke", smoke_config("rwkv6-1.6b"), (16, 64))):
        D = cfg.rwkv.head_dim
        for T in T_all:
            cases[f"rwkv6 {label} T={T}"] = rwkv_launch(1, T, cfg.d_model // D, D, cfg.rwkv.chunk)
    for arch in ("smollm-360m", "rwkv6-1.6b"):
        numels = [p.numel() for p in transformer.Transformer(get_config(arch), torch.device("meta")).parameters()]
        for i, launch in enumerate(accum_launches(numels)):
            cases[f"weighted_accum {arch} tree launch {i}"] = launch
    return cases
