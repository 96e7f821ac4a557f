"""The MoE family on the port against the JAX package, on the CPU.

* ``_top_k_dispatch`` is bit-equal to the reference's, ties included (the
  lower expert index wins, as in ``jax.lax.top_k``);
* ``kernels.ops.moe_dispatch`` (the masks of every group at once, the op
  ``moe_apply`` calls) equals ``_top_k_dispatch`` a group at a time bit for
  bit, in its plain version: dispatch, combine and the kept counts in float32
  and bfloat16, with capacity drops, a held route with a repeated expert and
  a decode group of 8, and the router's gradient through combine; on meta
  tensors it gives the shapes and launches nothing;
* ``moe_apply`` gives the reference's ``out``, ``aux_loss``, ``z_loss`` and
  ``dropped_frac`` within ``TOL`` in float32: a prefill group with capacity
  drops, the decode group of 8 slots whose idle rows route too (and take
  capacity from the later rows), several groups, the ungated ffn;
* the converter carries the expert stacks and the Mamba leaves both ways,
  parameters and train state, in a stacked body (an expert leaf is
  (R, E, d_in, d_out) there) and in jamba's 7-layer cut, which is a tail
  only; ``reference_ndims`` is each leaf's rank in the reference's tree;
* ``forward``, ``loss_fn`` (with the MoE auxiliary losses) and their
  gradients against ``jax.grad`` for olmoe's and jamba's smoke configs;
* greedy tokens of the port's ``ServeEngine`` equal the JAX engine's on the
  naive, flash and paged routes for olmoe's and phi3.5-moe's smoke configs,
  through ``serve_loop`` with slot reuse (weights carried across by
  ``params_from_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.dist import HeteroStepConfig as JStepConfig
from repro.dist import init_train_state as jax_init_train_state
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models.moe import _top_k_dispatch as jax_top_k_dispatch
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_apply as jax_moe_apply
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import WorkloadConfig as JWorkloadConfig
from repro.serve import serve_loop as jax_serve_loop
from repro.serve import synthesize as jax_synthesize
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import forward, loss_fn
from repro_torch.models.convert import (
    _tree_from_named,
    params_from_jax,
    params_to_jax,
    reference_ndims,
    reference_paths,
    train_state_from_jax,
    train_state_to_jax,
)
from repro_torch.models.moe import MoE, _top_k_dispatch, moe_apply
from repro_torch.serve import SchedulerConfig, ServeEngine, WorkloadConfig, serve_loop, synthesize

TOL = 1e-5  # float32: out, the losses and dropped_frac; the loss and gradients against jax.grad
SEQ = 64
WORKLOAD = dict(n_requests=4, prompt_len=(3, 30), gen_len=(3, 12), vocab_size=512, seed=0)


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _moe_pair(arch, capacity_factor=None, gated=True, seed=0):
    """(JAX config, port config, reference MoE params, the port's MoE with those weights)."""
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=SEQ), tconfigs.smoke_config(arch, seq=SEQ)
    cf = capacity_factor or jcfg.moe.capacity_factor
    jcfg = dataclasses.replace(jcfg, mlp_gated=gated, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, mlp_gated=gated, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jp = jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(seed), jcfg))
    tp = MoE(tcfg, device="cpu")
    tp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, strict=True)
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _gates(case):
    rng = np.random.default_rng(7)
    if case == "random":
        logits = rng.standard_normal((24, 8)).astype(np.float32)
        return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    # exact ties: equal gates across experts, and a tie at the k-th place
    g = np.full((12, 8), 0.125, np.float32)
    g[1] = [0.1, 0.3, 0.1, 0.3, 0.05, 0.05, 0.05, 0.05]
    g[4] = [0.2, 0.2, 0.2, 0.1, 0.1, 0.1, 0.05, 0.05]
    g[7:] = g[4][::-1]
    return g


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("k,capacity", [(2, 4), (2, 8), (8, 12), (1, 4)])
def test_top_k_dispatch_is_bit_equal_to_the_reference(case, k, capacity):
    gates = _gates(case)
    jd, jc = jax_top_k_dispatch(jnp.asarray(gates), k, capacity)
    td, tc = _top_k_dispatch(torch.tensor(gates), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if capacity == 4 and k == 2:
        assert (td.sum(dim=(1, 2)) < k).any()  # some choices dropped by capacity


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _decode_group_input(d):
    """8 slots of one decode step: rows 0, 2, 5 and 6 idle, holding one stale
    token's state, which routes them all alike and fills two experts early."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 1, d)).astype(np.float32)
    x[[0, 2, 5, 6]] = x[0]
    return x


MOE_CASES = {
    # name: (arch, capacity_factor, gated, input shape or "decode", group_size, drops expected)
    "prefill group, drops": ("phi3.5-moe-42b-a6.6b", 0.5, True, (1, 32), 2048, True),
    "decode group of 8 slots, idle rows": ("phi3.5-moe-42b-a6.6b", None, True, "decode", 8, True),
    "two groups, no drop": ("phi3.5-moe-42b-a6.6b", None, True, (2, 16), 16, False),
    "olmoe top-8 of 8": ("olmoe-1b-7b", None, True, (2, 24), 2048, False),
    "ungated ffn, drops": ("phi3.5-moe-42b-a6.6b", 0.6, False, (3, 8), 2048, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_the_reference(case):
    arch, cf, gated, shape, group, drops = MOE_CASES[case]
    jcfg, tcfg, jp, tp = _moe_pair(arch, cf, gated)
    if shape == "decode":
        x = _decode_group_input(jcfg.d_model)
    else:
        x = np.random.default_rng(3).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    jout, jm = jax_moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg, group_size=group)
    with torch.no_grad():
        tout, tm = moe_apply(tp, torch.from_numpy(x), tcfg, group_size=group)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=TOL, atol=TOL)
    for key in ("aux_loss", "z_loss", "dropped_frac"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL, atol=TOL, err_msg=key)
    assert (float(tm["dropped_frac"]) > 0) == drops


def test_moe_apply_routes_by_a_given_choice():
    """``top_idx`` replays a route: its own gives the same bits; every token
    sent to experts 0 and 1 fills their capacity in token order and drops
    the rest (the comparison of two attention routes with routing held fixed)."""
    _, tcfg, _, tp = _moe_pair("phi3.5-moe-42b-a6.6b")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 32, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        out, m = moe_apply(tp, x, tcfg)
        again, m2 = moe_apply(tp, x, tcfg, top_idx=m["top_idx"])
        assert torch.equal(out, again) and torch.equal(m["top_idx"], m2["top_idx"])
        forced = torch.tensor([0, 1]).expand(1, 32, 2)
        _, mf = moe_apply(tp, x, tcfg, top_idx=forced)
    capacity = -(-max(int(2 * 32 / 8 * 1.25), 1) // 4) * 4
    assert m["top_idx"].shape == (1, 32, 2) and float(mf["dropped_frac"]) == (32 - capacity) / 32


# ---------------------------------------------------------------------------
# the routing masks of all groups in one op (kernels.ops.moe_dispatch)
# ---------------------------------------------------------------------------

# name: (groups G, tokens a group g, experts E, top-k, capacity factor, "repeated" (a held top_idx),
# "idle rows" (five decode rows routed alike) or None)
DISPATCH_CASES = {
    "two groups": (2, 24, 8, 2, 1.25, None),
    "phi3.5-moe capacity drops": (1, 64, 16, 2, 0.5, None),
    "held top_idx, repeated expert": (2, 16, 8, 3, 1.0, "repeated"),
    "decode group of 8": (1, 8, 16, 2, 1.25, "idle rows"),
    "olmoe top-8 of 64": (2, 64, 64, 8, 1.25, None),
}


def _dispatch_inputs(case):
    """(gates (G, g, E) float32, top_idx (G, g, k), capacity) of a case, made with numpy."""
    G, g, E, k, cf, held = DISPATCH_CASES[case]
    rng = np.random.default_rng(G * 100 + g + E + k)
    logits = torch.from_numpy(2 * rng.standard_normal((G, g, E)).astype(np.float32))
    if held == "idle rows":  # idle slots hold one stale token's state: more than the capacity on one expert
        logits[:, [0, 2, 4, 5, 6]] = logits[:, :1].clone()
    gates = torch.softmax(logits, dim=-1)
    if held != "repeated":
        top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)[1][..., :k].contiguous()
    else:  # every token's first choice expert 0 (drops past capacity), some tokens' expert twice
        top_idx = torch.from_numpy(rng.integers(0, E, (G, g, k)))
        top_idx[..., 0] = 0
        top_idx[:, ::3, 2] = top_idx[:, ::3, 1]
    capacity = -(-max(int(k * g / E * cf), 1) // 4) * 4
    return gates, top_idx, capacity


def _loop_masks(gates, top_idx, capacity, dtype):
    """``_top_k_dispatch`` a group at a time, cast as moe_apply did: (dispatch, combine, routed)."""
    k = top_idx.shape[-1]
    pairs = [_top_k_dispatch(gates[i], k, capacity, top_idx[i]) for i in range(gates.shape[0])]
    dispatch = torch.stack([dc[0] for dc in pairs]).to(dtype)
    return dispatch, torch.stack([dc[1] for dc in pairs]).to(dtype), dispatch.sum(dim=(2, 3))


def _op_masks(gates, top_idx, capacity, dtype):
    top_vals = torch.gather(gates, 2, top_idx)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    return ops.moe_dispatch(top_idx, top_vals, gates.shape[-1], capacity, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_moe_dispatch_plain_equals_the_loop_per_group(case, dtype):
    """dispatch, combine and routed bit for bit; a slot for each kept choice, -1 for each dropped one."""
    gates, top_idx, capacity = _dispatch_inputs(case)
    want = _loop_masks(gates, top_idx, capacity, dtype)
    dispatch, combine, routed, slots = _op_masks(gates, top_idx, capacity, dtype)
    for name, got, w in zip(("dispatch", "combine", "routed"), (dispatch, combine, routed), want):
        assert got.dtype == dtype and got.shape == w.shape and torch.equal(got, w), name
    assert slots.dtype == torch.int32 and slots.shape == top_idx.shape
    assert torch.equal((slots >= 0).sum(-1).to(dtype), routed) and int(slots.max()) < capacity
    if case in ("phi3.5-moe capacity drops", "held top_idx, repeated expert", "decode group of 8"):
        assert (slots < 0).any()  # the capacity dropped some choices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_moe_dispatch_gate_gradient_equals_the_loop(case, dtype):
    """The router's gradient through combine (and the renormalisation) is the loop's, bit for bit."""
    gates, top_idx, capacity = _dispatch_inputs(case)
    G, g, E = gates.shape
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((G, g, E, capacity)).astype(np.float32))
    grads = []
    for masks in (_loop_masks, _op_masks):
        leaf = gates.clone().requires_grad_(True)
        combine = masks(leaf, top_idx, capacity, dtype)[1]
        grads.append(torch.autograd.grad((combine.float() * w).sum(), leaf)[0])
    assert grads[1].abs().max() > 0 and torch.equal(grads[1], grads[0])


def test_moe_dispatch_on_meta_gives_the_shapes_and_launches_nothing():
    ops.reset_launch_counts()
    top_idx = torch.empty((3, 16, 4), dtype=torch.int64, device="meta")
    top_vals = torch.empty((3, 16, 4), dtype=torch.float32, device="meta", requires_grad=True)
    dispatch, combine, routed, slots = ops.moe_dispatch(top_idx, top_vals, 8, 12, torch.bfloat16)
    assert all(t.device.type == "meta" for t in (dispatch, combine, routed, slots))
    assert dispatch.shape == combine.shape == (3, 16, 8, 12) and dispatch.dtype == combine.dtype == torch.bfloat16
    assert routed.shape == (3, 16) and slots.shape == (3, 16, 4) and slots.dtype == torch.int32
    (grad,) = torch.autograd.grad(combine.float().sum(), top_vals)
    assert grad.device.type == "meta" and grad.shape == (3, 16, 4) and grad.dtype == torch.float32
    assert combine.requires_grad and not dispatch.requires_grad
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


def test_moe_apply_routes_every_group_through_one_dispatch_call(monkeypatch):
    """Three groups, one op call; its routed is the loop's kept count a token."""
    _, tcfg, _, tp = _moe_pair("phi3.5-moe-42b-a6.6b", 0.5)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 16, tcfg.d_model)).astype(np.float32))
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return dispatch_op(*args)

    dispatch_op = ops.moe_dispatch
    monkeypatch.setattr(ops, "moe_dispatch", counting)
    with torch.no_grad():
        _, m = moe_apply(tp, x, tcfg, group_size=16)
        gates = torch.softmax(torch.einsum("gnd,de->gne", x, tp.router), dim=-1)
    capacity = -(-max(int(2 * 16 / 8 * 0.5), 1) // 4) * 4
    assert calls == [(3, 16, 2)]
    assert torch.equal(m["routed"], _loop_masks(gates, m["top_idx"], capacity, tcfg.dtype("compute"))[2])


def test_moe_module_keeps_the_reference_layout_and_a_float32_router():
    jcfg, tcfg, jp, tp = _moe_pair("phi3.5-moe-42b-a6.6b")
    assert {k: tuple(v.shape) for k, v in jp.items()} == {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    m = MoE(bf, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert m.router.dtype == torch.float32 and m.w_up.dtype == torch.bfloat16
    # each expert drawn on its own at the reference's scales
    assert m.w_up[0].float().abs().max() <= 3 * bf.d_model**-0.5 + 1e-3
    assert m.w_down.float().std() < m.w_up.float().std()


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [("olmoe-1b-7b", None), ("jamba-1.5-large-398b", 7)])
def test_params_and_train_state_cross_both_ways(arch, n_layers):
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=16), tconfigs.smoke_config(arch, seq=16)
    if n_layers:  # the chip's cut of jamba: the superblock's first 7 layers, all in the tail
        jcfg, tcfg = dataclasses.replace(jcfg, n_layers=n_layers), dataclasses.replace(tcfg, n_layers=n_layers)
        assert tcfg.n_repeats == 0 and len(tcfg.tail_layers) == 7
    jstate = jax.tree.map(np.asarray, jax_init_train_state(jcfg, JStepConfig(w_max=1, micro_bs=1, seq_len=16),
                                                            jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    jstate["opt"]["mu"] = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jstate["opt"]["mu"])
    tstate = train_state_from_jax(jstate, tcfg, device="cpu")
    back = train_state_to_jax(tstate, tcfg)
    flat_w, flat_g = (jax.tree_util.tree_leaves_with_path(t) for t in (jstate, back))
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))
    leaves = {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(jstate["params"])}
    if not n_layers:
        expert = next(v for k, v in leaves.items() if k.endswith("['ffn']['w_up']") and v.ndim == 4)
        assert expert.shape == (tcfg.n_repeats, tcfg.moe.n_experts, tcfg.d_model, tcfg.moe.d_ff_expert)
    params = tstate["params"]
    for path, ndim in zip(reference_paths(params, tcfg), reference_ndims(params, tcfg), strict=True):
        stacked = path.split("][")[-1].rstrip("]").isdigit()  # a body layer adds its [rep] index
        assert leaves[path.rsplit("[", 1)[0] if stacked else path].ndim == ndim, path
    again = params_to_jax(params_from_jax(back["params"], tcfg, device="cpu"), tcfg)
    assert jax.tree.structure(again) == jax.tree.structure(jstate["params"])


# ---------------------------------------------------------------------------
# the model: forward, loss and gradients against jax.grad
# ---------------------------------------------------------------------------


def _perturbed_params(jcfg, seed=0):
    """The reference's init with its zero-initialised norm gains moved off zero."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    leaves = [np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
              if "norm" in jax.tree_util.keystr(path) else np.asarray(a) for path, a in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_forward_loss_and_gradients_match_jax_grad(arch):
    S = 32
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=S), tconfigs.smoke_config(arch, seq=S)
    jp = _perturbed_params(jcfg)
    tp = params_from_jax(jp, tcfg, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(3)
    x = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) > 0.2).astype(np.float32)
    jbatch = {"inputs": jnp.asarray(x), "targets": jnp.asarray(y), "mask": jnp.asarray(mask)}
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jax_loss_fn(p, b, jcfg), has_aux=True))
    (jloss, jaux), jgrad = grad_fn(jp, jbatch)
    tbatch = {"inputs": torch.from_numpy(x).long(), "targets": torch.from_numpy(y).long(),
              "mask": torch.from_numpy(mask)}
    tloss, taux = loss_fn(tp, tbatch, tcfg)
    assert float(jaux["moe_aux"]) > 0
    for key in ("xent", "moe_aux"):
        np.testing.assert_allclose(_np(taux[key]), float(jaux[key]), rtol=TOL, atol=TOL, err_msg=key)
    np.testing.assert_allclose(_np(tloss), float(jloss), rtol=TOL, atol=TOL)
    names = [n for n, _ in tp.named_parameters()]
    tgrad = torch.autograd.grad(tloss, list(tp.parameters()))
    got = _tree_from_named({n: _np(g) for n, g in zip(names, tgrad)}, tcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL, err_msg=jax.tree_util.keystr(path))
    with torch.no_grad():
        tlogits, tm = forward(tp, tbatch["inputs"], tcfg)
    jlogits, jm = jax_forward(jp, jbatch["inputs"], jcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# serving: greedy tokens against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def arch_pair(request):
    arch = request.param
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=SEQ), tconfigs.smoke_config(arch, seq=SEQ)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return arch, jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.mark.parametrize("impl", ["naive", "flash", "paged"])
def test_greedy_tokens_equal_the_jax_engine(arch_pair, impl):
    _, jcfg, tcfg, jp, tp = arch_pair
    kw = dict(n_slots=2, max_seq=SEQ, attn_impl=impl, page_size=4)
    jeng, teng = JServeEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device="cpu", **kw)
    jreqs, treqs = jax_synthesize(JWorkloadConfig(**WORKLOAD)), synthesize(WorkloadConfig(**WORKLOAD))
    jsum = jax_serve_loop(jeng, jreqs, JSchedulerConfig(max_waiting_prefill=1))
    tsum = serve_loop(teng, treqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("completed", "gen_tokens", "ticks", "prefills", "slot_utilization"):
        assert tsum[key] == jsum[key], key
    assert tsum["prefills"] > teng.n_slots  # slots were reused
    if impl == "paged":
        assert teng.pool.metrics() == jeng.pool.metrics()
        teng.reset()  # leak audit


def test_eight_slot_decode_groups_with_idle_rows_equal_the_jax_engine(monkeypatch):
    """8 slots over 12 requests: decode routes all 8 rows as one group, idle
    slots included, with a capacity of 4 a group, so an idle row's choice can
    take capacity from a later slot's.  The port feeds idle rows what the
    reference's engine feeds them, and the tokens stay the JAX engine's."""
    import repro_torch.models.transformer as ttf

    # phi3.5's top-2 of 8 experts: a decode group of 8 can drop (olmoe's top-8 of 8 cannot)
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = jconfigs.smoke_config(arch, seq=SEQ), tconfigs.smoke_config(arch, seq=SEQ)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    dropped = []

    def recording(p, x, cfg, group_size=2048, top_idx=None):
        out, m = moe_apply(p, x, cfg, group_size, top_idx)
        if x.shape[1] == 1:
            dropped.append(float(m["dropped_frac"]))
        return out, m

    monkeypatch.setattr(ttf, "moe_apply", recording)
    wl = dict(n_requests=12, prompt_len=(3, 30), gen_len=(3, 24), vocab_size=512, seed=2)
    kw = dict(n_slots=8, max_seq=SEQ, attn_impl="paged", page_size=4)
    jeng, teng = JServeEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device="cpu", **kw)
    jreqs, treqs = jax_synthesize(JWorkloadConfig(**wl)), synthesize(WorkloadConfig(**wl))
    jsum = jax_serve_loop(jeng, jreqs, JSchedulerConfig(max_waiting_prefill=1))
    tsum = serve_loop(teng, treqs, SchedulerConfig(max_waiting_prefill=1))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert tsum["ticks"] == jsum["ticks"] and tsum["slot_utilization"] < 1.0  # idle rows ticked
    assert max(dropped) > 0  # some decode group dropped a token
