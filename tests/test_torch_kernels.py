"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's ``kernels.ops`` runs each kernel's plain PyTorch
version; those are held against the Pallas kernels run in interpret mode on
the same numpy inputs, at the tolerances of ``tests/test_kernels.py`` (2e-5
in float32, 3e-2 in bfloat16).  The ``gpu`` tests hold the CUDA kernels
against the plain versions on the card; they skip on a host without one.
JAX is imported inside the ``pallas`` fixture only, so the ``gpu`` tests also
run where JAX is not installed (``python -m pytest -m gpu`` on the card).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import weighted_accum as wa
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_cuda, flash_attention_ref
from repro_torch.kernels.moe_dispatch import (
    moe_dispatch_cuda,
    moe_dispatch_grad_cuda,
    moe_dispatch_grad_ref,
    moe_dispatch_ref,
)
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_ref
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
from repro_torch.kernels.weighted_accum import check_out_aliasing, weighted_accum_cuda, weighted_accum_ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the cases of tests/test_kernels.py (kept equal by test_cases_match_the_pallas_tests)
FLASH_CASES = [
    # B, Sq, Sk, H, Hkv, Dh, causal, window, softcap, q_offset, bq, bk
    (2, 128, 128, 4, 2, 64, True, None, 0.0, 0, 64, 64),
    (1, 256, 256, 8, 8, 128, True, None, 0.0, 0, 128, 128),
    (2, 128, 128, 4, 1, 64, True, 32, 0.0, 0, 32, 32),
    (1, 64, 64, 4, 2, 64, False, None, 50.0, 0, 32, 32),
    (1, 8, 128, 4, 2, 64, True, None, 0.0, 120, 8, 64),
    (2, 64, 64, 2, 2, 256, True, None, 0.0, 0, 64, 64),
]
PAGED_CASES = [
    # lengths, H, Hkv, window, softcap
    ([10, 3, 0], 4, 2, None, 0.0),
    ([8, 8], 4, 1, None, 0.0),
    ([23, 1], 4, 4, None, 0.0),
    ([20, 9], 4, 2, 6, 0.0),
    ([13, 2], 4, 2, None, 30.0),
    ([17, 5, 11], 8, 2, 5, 0.0),
]


# smollm-360m's head geometry: 15 query heads over 5 KV heads (G = 3), head_dim 64
SMOLLM_FLASH = (1, 64, 64, 15, 5, 64, True, None, 0.0, 0, 32, 32)
SMOLLM_PAGED = ([37, 16, 0, 5], 15, 5, None, 0.0)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas kernels (interpret mode) and jnp; skips without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.paged_attention import paged_attention

    return types.SimpleNamespace(jnp=jnp, flash=flash_attention, paged=paged_attention)


def _t(x, dt="float32", device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device, dtype=TORCH[dt] if x.dtype.kind == "f" else None)


def _close(out_t, out_j, dt):
    tol = TOL[dt]
    np.testing.assert_allclose(out_t.float().cpu().numpy(), np.asarray(out_j, np.float32), rtol=tol, atol=tol)


def _flash_inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, Dh = case[:6]
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, Sq, H, Dh), np.float32),
        rng.standard_normal((B, Sk, Hkv, Dh), np.float32),
        rng.standard_normal((B, Sk, Hkv, Dh), np.float32),
    )


def _paged_inputs(lengths, H, Hkv, Dh=64, n_pages=12, page_size=4, p_max=6, seed=0):
    """Pools and a page table covering ``lengths`` live tokens per slot, page ids
    handed out in a seeded shuffled order (scattered, non-monotonic tables)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, Dh), np.float32)
    k_pool = rng.standard_normal((n_pages + 1, page_size, Hkv, Dh), np.float32)
    v_pool = rng.standard_normal((n_pages + 1, page_size, Hkv, Dh), np.float32)
    order = rng.permutation(n_pages)
    table = np.full((B, p_max), -1, np.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        for j in range(-(-ln // page_size)):
            table[b, j] = order[nxt]
            nxt += 1
    assert nxt <= n_pages, "fixture pool too small"
    return q, k_pool, v_pool, table, np.array(lengths, np.int32)


def _quant_int8(x):
    """Symmetric per-(token, head) int8 quantisation with bf16-representable scales."""
    amax = np.abs(x).max(axis=-1)
    scale = torch.from_numpy(np.maximum(amax / 127.0, 1e-8)).to(torch.bfloat16).float().numpy()
    return np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8), scale


# ---------------------------------------------------------------------------
# plain versions (CPU) vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_cases_match_the_pallas_tests(pallas):
    import test_kernels

    assert FLASH_CASES == test_kernels.FLASH_CASES
    assert PAGED_CASES == test_kernels.PAGED_CASES


@pytest.mark.parametrize("case", FLASH_CASES + [SMOLLM_FLASH])
def test_flash_plain_matches_pallas_fp32(pallas, case):
    _, _, _, _, _, _, causal, window, softcap, qoff, bq, bk = case
    q, k, v = _flash_inputs(case)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    j = pallas.jnp.asarray
    want = pallas.flash(j(q), j(k), j(v), block_q=bq, block_kv=bk, interpret=True, **kw)
    got = ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want, "float32")


@pytest.mark.parametrize("case", [(1, 128, 128, 4, 2, 64, True, None, 0.0, 0, 64, 64), SMOLLM_FLASH])
def test_flash_plain_matches_pallas_bf16(pallas, case):
    *_, bq, bk = case
    q, k, v = _flash_inputs(case, seed=1)
    jq, jk, jv = (pallas.jnp.asarray(x, pallas.jnp.bfloat16) for x in (q, k, v))
    want = pallas.flash(jq, jk, jv, block_q=bq, block_kv=bk, interpret=True)
    got = ops.flash_attention(_t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_flash_plain_row_without_keys_is_zero():
    """The port's convention: a query row with every key masked gives 0."""
    q, k, v = _flash_inputs((1, 4, 8, 2, 1, 16))
    # q positions 20..23 against keys 0..7 with a window of 4: nothing in reach
    out = flash_attention_ref(_t(q), _t(k), _t(v), causal=True, window=4, q_offset=20)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("case", PAGED_CASES + [SMOLLM_PAGED])
def test_paged_plain_matches_pallas(pallas, case):
    lengths, H, Hkv, window, softcap = case
    q, kp, vp, table, lens = _paged_inputs(lengths, H, Hkv, n_pages=16, p_max=10, seed=len(lengths))
    kw = dict(window=window, softcap=softcap)
    want = pallas.paged(*map(pallas.jnp.asarray, (q, kp, vp, table, lens)), interpret=True, **kw)
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens), **kw)
    _close(got, want, "float32")


def test_paged_plain_matches_pallas_bf16(pallas):
    q, kp, vp, table, lens = _paged_inputs(*SMOLLM_PAGED[:3], n_pages=16, p_max=10, seed=3)
    js = [pallas.jnp.asarray(x, pallas.jnp.bfloat16) for x in (q, kp, vp)]
    want = pallas.paged(*js, pallas.jnp.asarray(table), pallas.jnp.asarray(lens), interpret=True)
    got = ops.paged_attention(*(_t(x, "bfloat16") for x in (q, kp, vp)), _t(table), _t(lens))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_paged_plain_empty_slot_is_zero():
    q, kp, vp, table, lens = _paged_inputs([7, 0], 4, 2)
    out = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_plain_int8_matches_pallas(pallas, q_dtype):
    q, kp, vp, table, lens = _paged_inputs([10, 5, 0], 15, 5, n_pages=8, p_max=4)
    k_i, k_s = _quant_int8(kp)
    v_i, v_s = _quant_int8(vp)
    jnp = pallas.jnp
    want = pallas.paged(
        jnp.asarray(q, getattr(jnp, q_dtype)), jnp.asarray(k_i), jnp.asarray(v_i), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(k_s, jnp.bfloat16), jnp.asarray(v_s, jnp.bfloat16), interpret=True,
    )
    got = ops.paged_attention(
        _t(q, q_dtype), _t(k_i), _t(v_i), _t(table), _t(lens), _t(k_s, "bfloat16"), _t(v_s, "bfloat16")
    )
    assert got.dtype == TORCH[q_dtype] and str(want.dtype) == q_dtype
    _close(got, want, q_dtype)


PAST_POOL = [  # (H, Hkv, Dh, page id past the pool): a 5-page pool (ids 0..4, scratch 5), page_size 4
    (4, 2, 64, 7),
    (15, 5, 64, 1000),
]


def _past_pool_inputs(H, Hkv, Dh, past, seed=21):
    """Pages [[0, past]] on a 5-page pool, length 8, and the same table naming the scratch page."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, Dh), np.float32)
    k_pool, v_pool = (rng.standard_normal((6, 4, Hkv, Dh), np.float32) for _ in range(2))
    return q, k_pool, v_pool, np.array([[0, past]], np.int32), np.array([[0, 5]], np.int32), np.array([8], np.int32)


@pytest.mark.parametrize("H,Hkv,Dh,past", PAST_POOL)
def test_paged_plain_attends_a_page_past_the_pool_as_the_scratch_page(pallas, H, Hkv, Dh, past):
    """A page id >= n_pages + 1 names the scratch page and stays live: the port
    follows the JAX package, whose gather and Pallas block fetch clamp."""
    from repro.kernels.ref import paged_attention_ref as jax_paged_ref

    q, kp, vp, table, scratch_table, lens = _past_pool_inputs(H, Hkv, Dh, past)
    jnp = pallas.jnp
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    _close(got, pallas.paged(*map(jnp.asarray, (q, kp, vp, table, lens)), interpret=True), "float32")
    _close(got, jax_paged_ref(*map(jnp.asarray, (q, kp, vp, table, lens))), "float32")
    assert torch.equal(got, ops.paged_attention(_t(q), _t(kp), _t(vp), _t(scratch_table), _t(lens)))


def test_paged_plain_matches_flash_plain_contiguous():
    """A contiguous single slot: paged decode equals flash attention's last query row."""
    L = 11
    q, kp, vp, table, lens = _paged_inputs([L], 4, 2, n_pages=4, p_max=4)
    out = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    k = np.concatenate([kp[p] for p in table[0] if p >= 0])[:L]
    v = np.concatenate([vp[p] for p in table[0] if p >= 0])[:L]
    ref = ops.flash_attention(_t(q)[:, None], _t(k)[None], _t(v)[None], q_offset=L - 1)
    torch.testing.assert_close(out[0], ref[0, 0], rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the paged kernel's split-KV plan and its merge, plainly
# ---------------------------------------------------------------------------


@settings(max_examples=80, deadline=None)
@given(P=st.integers(0, 40), page_size=st.sampled_from([4, 8, 16, 128]), dh=st.sampled_from(pa.HEAD_DIMS),
       kv_bytes=st.sampled_from([1, 2, 4]), B=st.integers(1, 5), Hkv=st.integers(1, 5), G=st.integers(1, 8),
       lengths=st.lists(st.integers(0, 700), min_size=1, max_size=6),
       window=st.one_of(st.none(), st.integers(1, 300)))
def test_paged_split_plan_covers_every_live_page_once(P, page_size, dh, kv_bytes, B, Hkv, G, lengths, window):
    """The splits cut the page table into runs of ``pages_per_split`` slots;
    every live page (``_paged_kernel``'s predicate) lies in exactly one live
    split and every live split holds a live page; a tile of K and V rows fits
    the staging budget; grid, scratch and tickets follow from the plan."""
    plan = pa.plan_splits(B, Hkv, G, P, page_size, dh, kv_bytes)
    pps = plan.pages_per_split
    assert pps >= 1 and (plan.n_splits - 1) * pps < max(P, 1) <= plan.n_splits * pps
    assert 1 <= plan.tile_tokens <= min(pps * page_size, 128)  # the kernel stages one token a thread
    assert 2 * plan.tile_tokens * dh * kv_bytes <= pa.TILE_BYTES
    assert plan.tile_tokens == pps * page_size or pps == 1  # only a page above the budget is staged in tiles
    assert plan.blocks == B * Hkv * plan.n_splits
    assert plan.scratch_floats == plan.blocks * G * (dh + 2) and plan.tickets == B * Hkv
    for length in lengths:
        live = [j for j in range(P)
                if j * page_size < length and (window is None or (j + 1) * page_size > length - window)]
        splits = pa.live_splits(length, window, P, page_size, pps)
        assert all(0 <= s < plan.n_splits for s in splits)
        assert all(sum(s * pps <= j < (s + 1) * pps for s in splits) == 1 for j in live)
        assert all(any(s * pps <= j < (s + 1) * pps for j in live) for s in splits)


def _split_states(q, kp, vp, table, lens, bounds, k_s=None, v_s=None, window=None, softcap=0.0):
    """Each split's online-softmax state over the logical positions
    [bounds[i], bounds[i + 1]), plainly: m (S, B, H) with -inf where the split
    attends nothing, l (S, B, H) and acc (S, B, H, Dh), float32."""
    B, H, Dh = q.shape
    n_p1, page_size, Hkv, _ = kp.shape
    G = H // Hkv
    pos = torch.arange(table.shape[1] * page_size)
    pg = table.long()[:, pos // page_size]
    safe = torch.where(pg < 0, n_p1 - 1, pg)
    off = (pos % page_size)[None, :]
    k, v = kp[safe, off].float(), vp[safe, off].float()  # (B, S, Hkv, Dh)
    if k_s is not None:
        k, v = k * k_s[safe, off].float()[..., None], v * v_s[safe, off].float()[..., None]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, G, Dh).float(), k) * Dh**-0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = (pg >= 0) & (pos[None, :] < lens.long()[:, None])
    if window is not None:
        valid &= pos[None, :] > lens.long()[:, None] - 1 - window
    ms, ls, accs = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        vm = valid[:, None, None, lo:hi]
        sv = torch.where(vm, s[..., lo:hi], -torch.inf)
        m = sv.amax(-1) if hi > lo else torch.full((B, Hkv, G), -torch.inf)
        p = torch.where(vm, torch.exp(sv - torch.where(torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        ms.append(m.reshape(B, H))
        ls.append(p.sum(-1).reshape(B, H))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, v[:, lo:hi]).reshape(B, H, Dh))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _split_bounds(n_tokens, rng, page_size, pps):
    """Three ways to cut [0, n_tokens): the kernel's runs of pps pages, random
    cut points (repeats make empty splits), and one split of everything."""
    cuts = np.sort(rng.integers(0, n_tokens + 1, size=5))
    return {
        "kernel": list(range(0, n_tokens, pps * page_size)) + [n_tokens],
        "random": [0, *cuts.tolist(), n_tokens],
        "one": [0, n_tokens],
    }


@pytest.mark.parametrize("case", PAGED_CASES + [SMOLLM_PAGED])
def test_paged_split_merge_matches_ref_and_pallas(pallas, case):
    """Per-split states merged in split order equal the gather-then-attend
    version and the Pallas kernel, however the positions are split: the
    kernel's runs of pages, random cuts with empty splits, one split.  Empty
    slots give 0."""
    lengths, H, Hkv, window, softcap = case
    q, kp, vp, table, lens = _paged_inputs(lengths, H, Hkv, n_pages=16, p_max=10, seed=len(lengths) + 7)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(pallas.paged(*map(pallas.jnp.asarray, (q, kp, vp, table, lens)), interpret=True, **kw))
    args = tuple(map(_t, (q, kp, vp, table, lens)))
    ref = paged_attention_ref(*args, **kw)
    plan = pa.plan_splits(len(lengths), Hkv, H // Hkv, table.shape[1], kp.shape[1], q.shape[-1], 4)
    rng = np.random.default_rng(len(lengths))
    for name, bounds in _split_bounds(table.shape[1] * kp.shape[1], rng, kp.shape[1], plan.pages_per_split).items():
        got = pa.merge_split_states(*_split_states(*args, bounds, **kw))
        _close(got, want, "float32")
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5, msg=lambda m: f"{name} splits: {m}")
        assert torch.equal(got[lens == 0], torch.zeros_like(got[lens == 0]))


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_split_merge_int8_matches_pallas(pallas, q_dtype):
    """int8 pools: the per-split states dequantise with the per-token scales,
    and the merge equals the Pallas kernel on the same quantised pools."""
    q, kp, vp, table, lens = _paged_inputs([10, 5, 0], 15, 5, n_pages=8, p_max=4, seed=11)
    k_i, k_s = _quant_int8(kp)
    v_i, v_s = _quant_int8(vp)
    jnp = pallas.jnp
    want = pallas.paged(
        jnp.asarray(q, getattr(jnp, q_dtype)), jnp.asarray(k_i), jnp.asarray(v_i), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(k_s, jnp.bfloat16), jnp.asarray(v_s, jnp.bfloat16), interpret=True,
    )
    qt = _t(q, q_dtype)
    for bounds in ([0, 4, 4, 9, 16], [0, 3, 16]):
        m, l, acc = _split_states(qt, _t(k_i), _t(v_i), _t(table), _t(lens), bounds, _t(k_s, "bfloat16"),
                                  _t(v_s, "bfloat16"))
        _close(pa.merge_split_states(m, l, acc).to(TORCH[q_dtype]), want, q_dtype)


def test_paged_split_merge_of_empty_splits_is_zero():
    """Splits that attend nothing (m = -inf or the kernel's finite NEG_INF, l = 0)
    merge to 0, alone or beside a live split, which they leave unchanged."""
    m_live, l_live, acc_live = torch.tensor([[1.5]]), torch.tensor([[2.0]]), torch.tensor([[[3.0, -1.0]]])
    for empty_m in (-torch.inf, NEG_INF):
        m_e, l_e, acc_e = torch.full((1, 1), empty_m), torch.zeros((1, 1)), torch.zeros((1, 1, 2))
        assert torch.equal(pa.merge_split_states(m_e[None], l_e[None], acc_e[None]), torch.zeros((1, 1, 2)))
        got = pa.merge_split_states(torch.stack([m_e, m_live, m_e]), torch.stack([l_e, l_live, l_e]),
                                    torch.stack([acc_e, acc_live, acc_e]))
        assert torch.equal(got, acc_live / l_live[..., None])


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper of a CUDA kernel never runs a plain version: CPU tensors raise."""
    q, k, v = _flash_inputs((1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(_t(q), _t(k), _t(v))
    q, kp, vp, table, lens = _paged_inputs([3], 2, 1, Dh=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention_cuda(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    r, k, v, w = (torch.rand((1, 16, 1, 16)) for _ in range(4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_scan_cuda(r, k, v, w, torch.rand((1, 16)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        weighted_accum_cuda(torch.ones(4), torch.ones(4), 1.0)
    top_idx, slots = torch.zeros((1, 4, 2), dtype=torch.int64), torch.zeros((1, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_dispatch_cuda(top_idx, torch.ones((1, 4, 2)), 8, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_dispatch_grad_cuda(torch.ones((1, 4, 8, 4)), top_idx, slots)
    assert ops.launch_counts() == {"flash_attention": 0, "moe_dispatch": 0, "moe_dispatch_grad": 0,
                                   "paged_attention": 0, "rwkv6_scan": 0, "weighted_accum": 0}


def test_weighted_accum_out_may_alias_acc_exactly_and_nothing_else():
    """The kernel reads g as ``__restrict__`` and writes each element once: out
    may be acc itself, and may share no other memory with acc or g."""
    acc, g = torch.zeros(64), torch.zeros(64)
    check_out_aliasing(acc, g, acc)
    check_out_aliasing(acc, g, torch.zeros(64))
    check_out_aliasing(acc[:32], g[:32], acc[:32])
    check_out_aliasing(acc[:32], g[:32], acc[32:])  # the other half of acc's storage: disjoint
    for name, out in (("g", g), ("g", g[1:].reshape(63)[:32]), ("acc", acc[1:33])):
        with pytest.raises(ValueError, match=f"out overlaps {name}"):
            check_out_aliasing(acc[:32], g[:32], out[:32])


# the multi-tensor accumulation: one tensor's (numel, acc code, g code, acc,
# g and out offsets in elements from their 4 KB-aligned bases, out is acc)
_TENSOR = st.tuples(st.integers(0, 3000), st.sampled_from([0, 1]), st.sampled_from([0, 1]), st.integers(0, 15),
                    st.integers(0, 15), st.integers(0, 15), st.booleans())


def _addresses(tree):
    """Addresses of each tensor's acc, g and out, far apart, at the given element offsets."""
    acc, g, out = [], [], []
    for i, (n, ac, gc, oa, og, oo, in_place) in enumerate(tree):
        ea, eg = wa.ELEM_BYTES[ac], wa.ELEM_BYTES[gc]
        base = (i + 1) << 20
        acc.append(base + oa * ea)
        g.append(base + (1 << 18) + og * eg)
        out.append(acc[-1] if in_place else base + (2 << 18) + oo * ea)
    return acc, g, out


@settings(max_examples=60, deadline=None)
@given(st.lists(_TENSOR, min_size=1, max_size=24), st.integers(1, 9), st.sampled_from([1, 3, 64, wa.CHUNK_VECS]))
def test_accum_planner_covers_every_element_exactly_once(tree, max_tensors, chunk_vecs):
    """Every element of every nonempty tensor is taken by exactly one chunk of
    one launch, vectors only where acc, g and out are all aligned to them; a
    launch never mixes types nor holds more than its table; empty tensors
    are left out; the packed table reads back as planned."""
    numels = [t[0] for t in tree]
    acc_codes, g_codes = [t[1] for t in tree], [t[2] for t in tree]
    acc, g, out = _addresses(tree)
    launches = wa.plan_tree(numels, acc_codes, g_codes, acc, g, out, max_tensors=max_tensors, chunk_vecs=chunk_vecs)
    seen = np.concatenate([launch.index for launch in launches]) if launches else np.zeros(0, np.int64)
    assert sorted(seen.tolist()) == [i for i, n in enumerate(numels) if n > 0]
    for launch in launches:
        k = len(launch.index)
        assert 1 <= k <= max_tensors
        assert all(acc_codes[i] == launch.acc_code and g_codes[i] == launch.g_code for i in launch.index)
        table = wa.pack_table(launch, numels, acc, g, out, scale_addr=12345)
        assert table.nbytes == wa.TABLE_BYTES <= 32764
        lay = wa.TABLE_LAYOUT
        assert table[lay["count"] : lay["count"] + 4].view(np.int32)[0] == k
        assert table[lay["scale"] : lay["scale"] + 8].view(np.int64)[0] == 12345
        assert np.array_equal(table[lay["n"] : lay["n"] + 8 * k].view(np.int64), np.take(numels, launch.index))
        assert np.array_equal(table[lay["chunk_start"] :][: 4 * (k + 1)].view(np.int32), launch.chunk_start)
        width = 16 // wa.ELEM_BYTES[launch.acc_code]
        cover = {int(i): np.zeros(numels[i], np.int64) for i in launch.index}
        for c in range(int(launch.chunk_start[-1])):
            t = int(np.searchsorted(launch.chunk_start, c, side="right")) - 1
            i, head = int(launch.index[t]), int(launch.head[t])
            j, last = c - int(launch.chunk_start[t]), c + 1 == launch.chunk_start[t + 1]
            scalars, vec = wa.chunk_spans(numels[i], head, j, last, width, chunk_vecs)
            for lo, hi in scalars:
                cover[i][lo:hi] += 1
            if vec is not None and vec[1] > vec[0]:
                cover[i][vec[0] : vec[1]] += 1
                ea, eg = wa.ELEM_BYTES[launch.acc_code], wa.ELEM_BYTES[launch.g_code]
                assert (acc[i] // ea + vec[0]) % width == (out[i] // ea + vec[0]) % width == 0
                assert (g[i] // eg + vec[0]) % width == 0 and (vec[1] - vec[0]) % width == 0
        assert all(np.all(cv == 1) for cv in cover.values())


def test_accum_planner_splits_a_tree_larger_than_one_table():
    n = wa.MAX_TENSORS * 2 + 5
    launches = wa.plan_tree([3] * n, [0] * n, [0] * n, [i << 12 for i in range(n)], [(n + i) << 12 for i in range(n)],
                            [i << 12 for i in range(n)])
    assert [len(launch.index) for launch in launches] == [wa.MAX_TENSORS, wa.MAX_TENSORS, 5]


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("scale", [0.37, 1.0, "tensor"])
def test_weighted_accum_tree_plain_equals_per_tensor_ref(in_place, scale):
    """On the CPU the tree goes through the plain version tensor by tensor:
    bit-equal to ``weighted_accum_ref`` per tensor, in place included."""
    rng = np.random.default_rng(8)
    pairs = [((7,), "float32", "float32"), ((3, 5), "bfloat16", "bfloat16"), ((0,), "float32", "float32"),
             ((1,), "float32", "bfloat16"), ((4, 33), "bfloat16", "float32"), ((960,), "float32", "float32")]
    acc = [_t(rng.standard_normal(s).astype(np.float32), adt) for s, adt, _ in pairs]
    g = [_t(rng.standard_normal(s).astype(np.float32), gdt) for s, _, gdt in pairs]
    s = torch.full((1,), 0.37) if scale == "tensor" else scale
    want = [weighted_accum_ref(a, b, s) for a, b in zip(acc, g)]
    got = ops.weighted_accum_tree(acc, g, s, out=acc if in_place else None)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    if in_place:
        assert all(x is a for x, a in zip(got, acc))


def test_weighted_accum_tree_aliasing_across_tensors():
    """In one launch the tensors are taken in no fixed order: an out may alias
    its own acc exactly, and shares no memory with any other tensor's acc, g or out."""
    base = torch.zeros(64)
    a, b, g = base[:16], base[16:32], torch.zeros(16)

    def check(accs, gs, outs):
        wa._check_tree_aliasing(*(np.array([wa._range(t) for t in ts], np.int64) for ts in (accs, gs, outs)))

    check([a, b], [g, g], [a, b])
    for accs, gs, outs, match in (([a, b], [g, g], [b, a], "out overlaps acc"),
                                  ([a, b], [g, g], [a, a], "two out tensors overlap"),
                                  ([a, b], [g, a], [a, b], "out overlaps g")):
        with pytest.raises(ValueError, match=match):
            check(accs, gs, outs)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# extra flash shapes for the card: ragged tiles, head dims 16/32, rows with no key in reach
FLASH_EDGE = [
    (2, 100, 100, 15, 5, 64, True, None, 0.0, 0, 0, 0),
    (1, 7, 130, 6, 2, 32, True, 9, 0.0, 123, 0, 0),
    (1, 33, 33, 4, 1, 16, False, 5, 20.0, 0, 0, 0),
    (1, 4, 8, 2, 1, 64, True, 4, 0.0, 20, 0, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + [SMOLLM_FLASH] + FLASH_EDGE)
def test_flash_cuda_matches_plain(cuda, case, dt):
    _, _, _, _, _, _, causal, window, softcap, qoff, _, _ = case
    q, k, v = (_t(x, dt, cuda) for x in _flash_inputs(case, seed=2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


# the bf16 route's tiles: every head dim (its swizzle mode follows the row width),
# ragged Sq/Sk off the 64-row tiles, windows and softcap, a 2048-token prompt at smollm's heads
FLASH_WGMMA = [(1, 130, 130, 4, 2, dh, True, None, 0.0, 0, 0, 0) for dh in HEAD_DIMS] + [
    (1, 100, 163, 4, 2, 64, True, None, 0.0, 63, 0, 0),
    (2, 77, 77, 6, 3, 128, False, 20, 30.0, 0, 0, 0),
    (1, 37, 101, 4, 1, 32, True, 50, 0.0, 64, 0, 0),
    (1, 65, 65, 2, 1, 256, False, None, 0.0, 0, 0, 0),
    (1, 2048, 2048, 15, 5, 64, True, None, 0.0, 0, 0, 0),
    # the dense family's heads: gemma-7b's 16/16 of 256, yi-34b's group of 7,
    # gemma3-27b's 1024-token window over a 1280-token prompt
    (1, 130, 130, 16, 16, 256, True, None, 0.0, 0, 0, 0),
    (1, 256, 256, 56, 8, 128, True, None, 0.0, 0, 0, 0),
    (1, 1280, 1280, 32, 16, 128, True, 1024, 0.0, 0, 0, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_WGMMA)
def test_flash_cuda_head_dims_ragged_and_long_match_plain(cuda, case, dt):
    _, _, _, _, _, _, causal, window, softcap, qoff, _, _ = case
    q, k, v = (_t(x, dt, cuda) for x in _flash_inputs(case, seed=3))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.gpu
def test_flash_cuda_bf16_refuses_rows_off_16_bytes(cuda):
    q, k, v = (_t(x, "bfloat16", cuda) for x in _flash_inputs((1, 8, 8, 2, 1, 64)))
    wide = torch.zeros((1, 8, 1, 72), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, wide[..., 4:68], v)


PAGED_EDGE = [
    ([37, 16, 0, 5], 15, 5, None, 0.0),  # smollm geometry, an empty slot
    ([40, 33, 1], 15, 5, 7, 30.0),  # window + softcap at G = 3
    ([9, 30], 8, 1, None, 0.0),  # MQA, G = 8
    ([23, 40, 2], 56, 8, None, 0.0),  # yi-34b's heads, G = 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES + PAGED_EDGE)
@pytest.mark.parametrize("page_size,dh", [(4, 64), (16, 64), (8, 128), (4, 256), (8, 16)])
def test_paged_cuda_matches_plain(cuda, case, dt, page_size, dh):
    lengths, H, Hkv, window, softcap = case
    q, kp, vp, table, lens = _paged_inputs(lengths, H, Hkv, Dh=dh, n_pages=40, page_size=page_size, p_max=12, seed=4)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    table, lens = _t(table, device=cuda), _t(lens, device=cuda)
    before = paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, table, lens, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    want = paged_attention_ref(q, kp, vp, table, lens, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    assert torch.equal(got[lens == 0], torch.zeros_like(got[lens == 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_cuda_int8_matches_plain(cuda, q_dtype):
    q, kp, vp, table, lens = _paged_inputs([29, 5, 0, 16], 15, 5, n_pages=16, page_size=4, p_max=8, seed=5)
    k_i, k_s = _quant_int8(kp)
    v_i, v_s = _quant_int8(vp)
    args = (
        _t(q, q_dtype, cuda), _t(k_i, device=cuda), _t(v_i, device=cuda), _t(table, device=cuda),
        _t(lens, device=cuda), _t(k_s, "bfloat16", cuda), _t(v_s, "bfloat16", cuda),
    )
    got = ops.paged_attention(*args, window=12)
    want = paged_attention_ref(*args, window=12)
    assert got.dtype == want.dtype == TORCH[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[q_dtype], atol=TOL[q_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_paged_cuda_int8_at_gemma_7b_shape_matches_plain(cuda, q_dtype):
    """gemma-7b's decode: 16 kv heads of 256 (G = 1), int8 pools with bf16
    scales, page 16, so 64-token splits of 4 pages, slots past one split."""
    q, kp, vp, table, lens = _paged_inputs([300, 17, 160, 0], 16, 16, Dh=256, n_pages=40, page_size=16, p_max=24,
                                           seed=6)
    (k_i, k_s), (v_i, v_s) = _quant_int8(kp), _quant_int8(vp)
    args = (
        _t(q, q_dtype, cuda), _t(k_i, device=cuda), _t(v_i, device=cuda), _t(table, device=cuda),
        _t(lens, device=cuda), _t(k_s, "bfloat16", cuda), _t(v_s, "bfloat16", cuda),
    )
    assert pa.plan_splits(4, 16, 1, 24, 16, 256, 1).tile_tokens == 64
    got = ops.paged_attention(*args)
    want = paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[q_dtype], atol=TOL[q_dtype])
    assert torch.equal(got[3], torch.zeros_like(got[3]))


def _paged_long(dt, dh, device, seed=12):
    """Slots of about 2048 tokens at smollm's heads over 128 page-table slots
    of 16 tokens (32 splits of 4 pages), beside a short slot and an empty one."""
    lengths = [2048, 1999, 1537, 37, 0]
    q, kp, vp, table, lens = _paged_inputs(lengths, 15, 5, Dh=dh, n_pages=360, page_size=16, p_max=128, seed=seed)
    return tuple(_t(x, dt, device) for x in (q, kp, vp)) + (_t(table, device=device), _t(lens, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (300, 0.0), (None, 30.0)])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_cuda_long_slots_over_many_splits_match_plain(cuda, dt, dh, window, softcap):
    """2048-token slots: every split of a slot live (or, under a window, the
    last few), merged inside the launch; one launch."""
    args = _paged_long(dt, dh, cuda)
    assert pa.plan_splits(5, 5, 3, 128, 16, dh, 4 if dt == "float32" else 2).n_splits >= 16
    before = paged_attention_cuda.launches
    got = ops.paged_attention(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    want = paged_attention_ref(*args, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_cuda_is_bit_identical_across_calls_and_shapes(cuda, dt):
    """The in-kernel merge runs in split order, so repeated calls give the same
    bits; calls at other shapes in between leave the ticket buffer zeroed, so
    the third call equals the first."""
    long_args = _paged_long(dt, 64, cuda)
    q, kp, vp, table, lens = _paged_inputs([37, 16, 0, 5], 15, 5, n_pages=16, page_size=4, p_max=12, seed=13)
    short_args = tuple(_t(x, dt, cuda) for x in (q, kp, vp)) + (_t(table, device=cuda), _t(lens, device=cuda))
    first = paged_attention_cuda(*long_args)
    assert torch.equal(paged_attention_cuda(*long_args), first)
    short = paged_attention_cuda(*short_args)
    assert torch.equal(paged_attention_cuda(*long_args, window=100), paged_attention_cuda(*long_args, window=100))
    assert torch.equal(paged_attention_cuda(*short_args), short)
    assert torch.equal(paged_attention_cuda(*long_args), first)


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (100, 20.0)])
@pytest.mark.parametrize("dt,int8", [("float32", False), ("bfloat16", False), ("bfloat16", True)])
def test_paged_cuda_pages_larger_than_a_tile_match_plain(cuda, dt, int8, window, softcap):
    """Pages of 128 tokens: each split is one page, staged in tiles of at most
    64 tokens with an online softmax across them, and slots of several pages
    merge their splits in the launch; int8 pools with their scales too."""
    q, kp, vp, table, lens = _paged_inputs([300, 129, 64, 0], 15, 5, Dh=64, n_pages=8, page_size=128, p_max=4,
                                           seed=14)
    assert pa.plan_splits(4, 5, 3, 4, 128, 64, 1 if int8 else TORCH[dt].itemsize).tile_tokens == 64
    if int8:
        (kp, k_s), (vp, v_s) = _quant_int8(kp), _quant_int8(vp)
        scales = (_t(k_s, "bfloat16", cuda), _t(v_s, "bfloat16", cuda))
        kp, vp = _t(kp, device=cuda), _t(vp, device=cuda)
    else:
        scales = ()
        kp, vp = _t(kp, dt, cuda), _t(vp, dt, cuda)
    args = (_t(q, dt, cuda), kp, vp, _t(table, device=cuda), _t(lens, device=cuda), *scales)
    got = ops.paged_attention(*args, window=window, softcap=softcap)
    want = paged_attention_ref(*args, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,Dh,past", PAST_POOL)
def test_paged_cuda_attends_a_page_past_the_pool_as_the_scratch_page(cuda, dt, H, Hkv, Dh, past):
    q, kp, vp, table, scratch_table, lens = _past_pool_inputs(H, Hkv, Dh, past)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    lens = _t(lens, device=cuda)
    got = paged_attention_cuda(q, kp, vp, _t(table, device=cuda), lens)
    assert torch.equal(got, paged_attention_cuda(q, kp, vp, _t(scratch_table, device=cuda), lens))
    want = paged_attention_ref(q, kp, vp, _t(table, device=cuda), lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.gpu
def test_paged_cuda_refuses_pools_off_16_bytes(cuda):
    q, kp, vp, table, lens = (_t(x, "bfloat16", cuda) if x.dtype.kind == "f" else _t(x, device=cuda)
                              for x in _paged_inputs([7, 3], 4, 2, Dh=64, n_pages=4, page_size=4, p_max=2))
    flat = torch.zeros(kp.numel() + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1 : kp.numel() + 1].view(kp.shape)  # contiguous, 2 bytes off the allocation's alignment
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_cuda(q, shifted, vp, table, lens)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_cuda(q, kp, shifted, table, lens)


# weighted_accum: tests/test_kernels.py's cases, mixed types, smollm-360m's largest gradient
ACCUM_GPU_CASES = [
    ((1000,), "float32", "float32"),
    ((33, 77), "float32", "float32"),
    ((8, 128), "bfloat16", "bfloat16"),
    ((5, 3, 7), "float32", "float32"),
    ((4097,), "float32", "bfloat16"),
    ((4099,), "bfloat16", "float32"),
    ((49152, 960), "float32", "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.37, 1.0, "device"])
@pytest.mark.parametrize("shape,acc_dt,g_dt", ACCUM_GPU_CASES)
def test_weighted_accum_cuda_equals_plain(cuda, shape, acc_dt, g_dt, scale):
    """Bit for bit: the kernel multiplies and adds in float32 without contraction."""
    rng = np.random.default_rng(6)
    acc = _t(rng.standard_normal(shape).astype(np.float32), acc_dt, cuda)
    g = _t(rng.standard_normal(shape).astype(np.float32), g_dt, cuda)
    s = torch.full((1,), 0.37, device=cuda) if scale == "device" else scale
    before = weighted_accum_cuda.launches
    got = ops.weighted_accum(acc, g, s)
    torch.cuda.synchronize()
    assert weighted_accum_cuda.launches == before + 1
    assert got.dtype == acc.dtype and torch.equal(got, weighted_accum_ref(acc, g, s))


@pytest.mark.gpu
def test_weighted_accum_cuda_offsets_in_place_and_refusals(cuda):
    base, gb = torch.randn(4099, device=cuda), torch.randn(4099, device=cuda)
    for a, g in ((base[1:], gb[1:]), (base[1:], gb[:-1]), (base[3:4], gb[3:4])):  # head, scalar path, one element
        assert torch.equal(ops.weighted_accum(a, g, 0.37), weighted_accum_ref(a, g, 0.37))
    for dt in (torch.float32, torch.bfloat16):
        acc, g = torch.randn(4097, device=cuda).to(dt), torch.randn(4097, device=cuda).to(dt)
        want = acc + g
        assert ops.weighted_accum(acc, g, 1.0, out=acc) is acc and torch.equal(acc, want)
    with pytest.raises(ValueError, match="contiguous"):
        weighted_accum_cuda(torch.ones((4, 4), device=cuda).T, torch.ones((4, 4), device=cuda), 1.0)
    with pytest.raises(ValueError, match="out overlaps g"):
        weighted_accum_cuda(base[:8], gb[:8], 1.0, out=gb[:8])
    with pytest.raises(ValueError, match="out overlaps acc"):
        weighted_accum_cuda(base[:8], gb[:8], 1.0, out=base[1:9])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        weighted_accum_cuda(torch.ones(4, device=cuda).half(), torch.ones(4, device=cuda).half(), 1.0)
    with pytest.raises(ValueError, match="scale must be one float32"):
        weighted_accum_cuda(torch.ones(4, device=cuda), torch.ones(4, device=cuda), torch.ones(2, device=cuda))


def _accum_trees(device):
    """Named trees of (acc, g) lists: mixed sizes with 1-element and empty
    tensors, odd-offset views, mixed dtype groups, more tensors than a table."""
    rng = np.random.default_rng(9)

    def rand(shape, dt):
        return _t(rng.standard_normal(shape).astype(np.float32), dt, device)

    spec = {
        "mixed sizes": [(sh, "float32", "float32") for sh in ((1000,), (1,), (0,), (960,), (33, 77), (5, 3, 7), (0, 4))],
        "mixed dtypes": [((n,), a, g) for n in (4097, 1, 33) for a in TORCH for g in TORCH],
        "larger than a table": [((1 + i % 13,), "float32", "float32") for i in range(wa.MAX_TENSORS + 20)],
    }
    trees = {name: ([rand(sh, a) for sh, a, _ in sp], [rand(sh, g) for sh, _, g in sp]) for name, sp in spec.items()}
    base = rand((9000,), "float32")
    views = [(1, 4100), (4103, 4110), (4111, 8000), (8003, 8004)]
    trees["odd offsets"] = ([base[a:b] for a, b in views], [rand((b - a + 3,), "float32")[3:] for a, b in views])
    return trees


@pytest.mark.gpu
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("name", ["mixed sizes", "mixed dtypes", "larger than a table", "odd offsets"])
def test_weighted_accum_cuda_tree_equals_plain(cuda, name, in_place):
    """One launch per (acc, g) type group and table; every tensor bit-equal to
    the plain version; the nonempty tensors counted."""
    accs, grads = _accum_trees(cuda)[name]
    groups = {}
    for a, g in zip(accs, grads):
        if a.numel():
            groups[a.dtype, g.dtype] = groups.get((a.dtype, g.dtype), 0) + 1
    want = [weighted_accum_ref(a, g, 0.37) for a, g in zip(accs, grads)]
    launches, tensors = weighted_accum_cuda.launches, weighted_accum_cuda.tensors
    got = ops.weighted_accum_tree(accs, grads, torch.full((1,), 0.37, device=cuda), out=accs if in_place else None)
    torch.cuda.synchronize()
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    assert weighted_accum_cuda.launches - launches == sum(-(-n // wa.MAX_TENSORS) for n in groups.values())
    assert weighted_accum_cuda.tensors - tensors == sum(groups.values())


# the MoE routing masks at the shapes the port routes: olmoe-1b-7b's training groups (the benchmark's
# cell), phi3.5-moe prefill with capacity drops, a decode group of 8 slots (five routed alike), and a
# held route with a repeated expert; name: (G, g, E, k, capacity factor, input)
MOE_DISPATCH_GPU_CASES = {
    "olmoe-1b-7b train groups": (4, 2048, 64, 8, 1.25, "router"),
    "phi3.5-moe prefill, drops": (1, 512, 16, 2, 0.5, "router"),
    "decode group of 8": (1, 8, 16, 2, 1.25, "idle rows"),
    "held route, repeated expert": (2, 96, 8, 3, 1.0, "repeated"),
}


def _moe_dispatch_case(name, device):
    """(gates (G, g, E) float32, top_idx (G, g, k) contiguous, capacity) made with numpy."""
    G, g, E, k, cf, kind = MOE_DISPATCH_GPU_CASES[name]
    rng = np.random.default_rng(g + E + k)
    logits = 2 * rng.standard_normal((G, g, E)).astype(np.float32)
    if kind == "idle rows":
        logits[:, [0, 2, 4, 5, 6]] = logits[:, :1]
    gates = torch.softmax(torch.from_numpy(logits).to(device), dim=-1)
    if kind == "repeated":
        idx = rng.integers(0, E, (G, g, k))
        idx[..., 0] = 0
        idx[:, ::3, 2] = idx[:, ::3, 1]
        top_idx = torch.from_numpy(idx).to(device)
    else:
        top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)[1][..., :k].contiguous()
    return gates, top_idx, -(-max(int(k * g / E * cf), 1) // 4) * 4


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MOE_DISPATCH_GPU_CASES))
def test_moe_dispatch_cuda_equals_plain_and_the_loop(cuda, name, dt):
    """dispatch, combine, routed, the slots and the gate's gradient bit for bit against the plain
    version on the card, and against the loop (``_top_k_dispatch`` a group at a time), the router's
    gradient through the renormalisation too; one launch each way."""
    from repro_torch.models.moe import _top_k_dispatch

    dtype = TORCH[dt]
    gates, top_idx, capacity = _moe_dispatch_case(name, cuda)
    G, g, E = gates.shape
    k = top_idx.shape[-1]
    leaf = gates.clone().requires_grad_(True)
    top_vals = torch.gather(leaf, 2, top_idx)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    before = (moe_dispatch_cuda.launches, moe_dispatch_grad_cuda.launches)
    got = ops.moe_dispatch(top_idx, top_vals, E, capacity, dtype)
    torch.cuda.synchronize()
    assert moe_dispatch_cuda.launches == before[0] + 1
    with torch.no_grad():
        want = moe_dispatch_ref(top_idx, top_vals, E, capacity, dtype)
    for label, x, y in zip(("dispatch", "combine", "routed", "slots"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), label
    pairs = [_top_k_dispatch(gates[i], k, capacity, top_idx[i]) for i in range(G)]
    loop = torch.stack([p[0] for p in pairs]).to(dtype)
    assert torch.equal(got[0], loop) and torch.equal(got[2], loop.sum(dim=(2, 3)))
    assert torch.equal(got[1], torch.stack([p[1] for p in pairs]).to(dtype))
    if name != "olmoe-1b-7b train groups":
        assert (got[3] < 0).any()  # the capacity dropped some choices
    grad_combine = torch.randn((G, g, E, capacity), device=cuda).to(dtype)
    grad, grad_gates = torch.autograd.grad(got[1], [top_vals, leaf], grad_combine)
    torch.cuda.synchronize()
    assert moe_dispatch_grad_cuda.launches == before[1] + 1
    assert torch.equal(grad, moe_dispatch_grad_ref(grad_combine, top_idx, got[3]))
    loop_leaf = gates.clone().requires_grad_(True)
    loop_combine = torch.stack([_top_k_dispatch(loop_leaf[i], k, capacity, top_idx[i])[1] for i in range(G)])
    (want_gates,) = torch.autograd.grad(loop_combine.to(dtype), loop_leaf, grad_combine)
    assert grad_gates.abs().max() > 0 and torch.equal(grad_gates, want_gates)
    # a transposed gradient is read through its strides
    t = grad_combine.transpose(2, 3).contiguous().transpose(2, 3)
    assert torch.equal(moe_dispatch_grad_cuda(t, top_idx, got[3]), grad)


@pytest.mark.gpu
def test_moe_dispatch_cuda_refusals(cuda):
    top_idx = torch.zeros((1, 8, 2), dtype=torch.int64, device=cuda)
    vals = torch.ones((1, 8, 2), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_dispatch_cuda(top_idx, vals, 8, 4, torch.float16)
    with pytest.raises(TypeError, match="int64"):
        moe_dispatch_cuda(top_idx.int(), vals, 8, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        moe_dispatch_cuda(torch.zeros((1, 2, 8), dtype=torch.int64, device=cuda).transpose(1, 2), vals, 8, 4,
                          torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        moe_dispatch_cuda(torch.zeros((1, 8, 64), dtype=torch.int64, device=cuda), torch.ones((1, 8, 64), device=cuda),
                          1024, 4, torch.bfloat16)


@pytest.mark.gpu
def test_moe_train_step_launches_the_masks_twice_a_layer_under_remat(cuda):
    """olmoe's smoke config (every layer MoE, bf16 compute) under remat: one launch a layer in the
    forward and one in its recomputation, a gradient launch a layer in the backward."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(smoke_config("olmoe-1b-7b", seq=64), remat=True, compute_dtype="bfloat16")
    assert all(s.moe for s in cfg.layer_specs())
    params = init_params(cfg, seed=0, device=cuda).requires_grad_(True)
    x = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    ops.reset_launch_counts()
    loss, _ = loss_fn(params, {"inputs": x, "targets": x}, cfg)
    torch.autograd.grad(loss, list(params.parameters()))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == 2 * cfg.n_layers and counts["moe_dispatch_grad"] == cfg.n_layers
