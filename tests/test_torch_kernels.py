"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's ``kernels.ops`` runs each kernel's plain PyTorch
version; those are held against the Pallas kernels run in interpret mode on
the same numpy inputs, at the tolerances of ``tests/test_kernels.py`` (2e-5
in float32, 3e-2 in bfloat16).  The ``gpu`` tests hold the CUDA kernels
against the plain versions on the card; they skip on a host without one.
JAX is imported inside the ``pallas`` fixture only, so the ``gpu`` tests also
run where JAX is not installed (``python -m pytest -m gpu`` on the card).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_ref
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


def test_paged_plain_matches_flash_plain_contiguous():
    """A contiguous single slot: paged decode equals flash attention's last query row."""
    L = 11
    q, kp, vp, table, lens = _paged_inputs([L], 4, 2, n_pages=4, p_max=4)
    out = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    k = np.concatenate([kp[p] for p in table[0] if p >= 0])[:L]
    v = np.concatenate([vp[p] for p in table[0] if p >= 0])[:L]
    ref = ops.flash_attention(_t(q)[:, None], _t(k)[None], _t(v)[None], q_offset=L - 1)
    torch.testing.assert_close(out[0], ref[0, 0], rtol=2e-5, atol=2e-5)


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
    assert ops.launch_counts() == {"flash_attention": 0, "paged_attention": 0, "rwkv6_scan": 0, "weighted_accum": 0}


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


PAGED_EDGE = [
    ([37, 16, 0, 5], 15, 5, None, 0.0),  # smollm geometry, an empty slot
    ([40, 33, 1], 15, 5, 7, 30.0),  # window + softcap at G = 3
    ([9, 30], 8, 1, None, 0.0),  # MQA, G = 8
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
