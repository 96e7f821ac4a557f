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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import ops
from repro_torch.kernels import weighted_accum as wa
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_cuda, flash_attention_ref
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
