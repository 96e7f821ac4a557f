"""The port's checkpoint and exact resume against the JAX package's, on the CPU.

* The on-disk format is the reference's: a train state the port writes
  restores through ``repro.checkpoint.restore_pytree`` into the JAX train
  state leaf for leaf, and a reference checkpoint restores into the port,
  with float32 AdamW moments (the default) and bfloat16 ones (stored as
  float32, back to bfloat16 exactly).
* A run killed at a step and resumed from its checkpoint gives the
  uninterrupted run's losses, allocations, fault log, parameters and AdamW
  moments bit for bit (simulated timing, smoke size).
* The resume guards refuse another policy, timing mode or data stream.
* Retention, auto-resume and the atomic write, as ``tests/test_checkpoint.py``
  holds them for the reference.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jax_restore_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.checkpoint import tree_paths as jax_tree_paths
from repro.configs import smoke_config as jax_smoke_config
from repro.dist import HeteroStepConfig as JStepConfig
from repro.dist import init_train_state as jax_init_train_state
from repro.runtime.driver import DriverConfig as JDriverConfig
from repro.runtime.driver import ElasticTrainer as JElasticTrainer
from repro_torch.checkpoint import CheckpointManager, as_train_state, restore_pytree, save_pytree, tree_paths
from repro_torch.configs import smoke_config
from repro_torch.checkpoint.checkpointer import _leaves_with_paths
from repro_torch.models.convert import train_state_from_jax, train_state_spec, train_state_to_jax
from repro_torch.runtime.driver import DriverConfig, ElasticTrainer

ARCH = "smollm-360m"
SEQ = 16


def _jax_state(moments="float32", seed=0):
    """The reference's AdamW train state at smoke size, its moments in
    ``moments`` and filled, with the counters, from a numpy seed."""
    jcfg = jax_smoke_config(ARCH, seq=SEQ)
    state = jax.tree.map(np.asarray, jax_init_train_state(jcfg, JStepConfig(w_max=1, micro_bs=1, seq_len=SEQ),
                                                           jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for key in ("mu", "nu"):
        state["opt"][key] = jax.tree.map(
            lambda x: np.asarray(jnp.asarray(rng.standard_normal(x.shape) * (1e-3 if key == "mu" else 1e-6),
                                             getattr(jnp, moments))),
            state["opt"][key])
    state["opt"]["count"] = np.asarray(7, np.int32)
    state["step"] = np.asarray(7, np.int32)
    return state


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32), err_msg=str(path))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_through_the_reference(tmp_path, moments):
    jstate = _jax_state(moments)
    tstate = train_state_from_jax(jstate, smoke_config(ARCH, seq=SEQ), device="cpu")
    assert tstate["opt"]["mu"][0].dtype == getattr(torch, moments)
    tree = train_state_to_jax(tstate, smoke_config(ARCH, seq=SEQ))
    assert tree_paths(tree) == jax_tree_paths(jstate)
    d = str(tmp_path / "ck")
    save_pytree(d, tree, metadata={"step": 7})
    restored, meta = jax_restore_pytree(d, jax.tree.map(np.zeros_like, jstate))
    assert meta == {"step": 7}
    _equal_trees(restored, jstate)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, moments):
    cfg = smoke_config(ARCH, seq=SEQ)
    jstate = _jax_state(moments, seed=1)
    d = str(tmp_path / "ck")
    jax_save_pytree(d, jstate, metadata={"step": 7})
    like = train_state_from_jax(_jax_state(moments, seed=2), cfg, device="cpu")
    tree, meta = restore_pytree(d, train_state_spec(like, cfg))
    opt_dtypes = {key: [t.dtype for t in like["opt"][key]] for key in ("mu", "nu")}
    got = as_train_state(tree, cfg, torch.device("cpu"), opt_dtypes)
    want = train_state_from_jax(jstate, cfg, device="cpu")
    assert meta == {"step": 7}
    for a, b in zip(got["params"].parameters(), want["params"].parameters(), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(got["opt"][key], want["opt"][key], strict=True):
            assert a.dtype == b.dtype == getattr(torch, moments) and torch.equal(a, b)
    assert int(got["opt"]["count"]) == int(got["step"]) == 7


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_train_state_spec_is_the_saved_tree_s_shapes_and_dtypes(moments):
    """The restore's like-tree: the keys, shapes and dtypes of the tree a save
    writes, with no array behind them."""
    cfg = smoke_config(ARCH, seq=SEQ)
    state = train_state_from_jax(_jax_state(moments), cfg, device="cpu")
    saved = _leaves_with_paths(train_state_to_jax(state, cfg))
    want = [(k, np.asarray(v).shape, np.asarray(v).dtype) for k, v in saved]
    got = [(k, v.shape, v.dtype) for k, v in _leaves_with_paths(train_state_spec(state, cfg))]
    assert got == want
    assert not any(isinstance(v, np.ndarray) for _, v in _leaves_with_paths(train_state_spec(state, cfg)))


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

RUN = dict(arch=ARCH, smoke=True, seq=SEQ, micro_bs=1, total_micro=8, n_workers=4, mode="while",
           hetero_gpus="v100,rtx2080ti,rtx2080ti,gtx1080ti", steps_per_epoch=3, policy="adaptive",
           events="replace@6:3=v100", faults="slow@2:1*3~3,netdeg@7:2~2", verbose=False, device="cpu")
STEPS = 9


@pytest.fixture(scope="module")
def uninterrupted():
    tr = ElasticTrainer(DriverConfig(**RUN, steps=STEPS))
    return tr, tr.run()


@pytest.mark.parametrize("kill_at", [4, 3, 6], ids=["mid-epoch", "epoch boundary", "membership event"])
def test_kill_and_resume_is_bit_exact(tmp_path, uninterrupted, kill_at):
    """A run killed after ``kill_at`` steps (its terminal checkpoint the last
    write) and resumed by a fresh trainer: every later loss, the allocations,
    the fault log, the parameters and the AdamW moments equal the
    uninterrupted run's bit for bit."""
    u, ures = uninterrupted
    ck = str(tmp_path / "ck")
    a = ElasticTrainer(DriverConfig(**RUN, steps=kill_at, ckpt_dir=ck, ckpt_every=2))
    ares = a.run()
    assert CheckpointManager(ck).latest_step() == kill_at
    b = ElasticTrainer(DriverConfig(**RUN, steps=STEPS, ckpt_dir=ck, ckpt_every=2, resume=True))
    assert b.step_i == kill_at
    bres = b.run()
    assert a.losses + b.losses == u.losses
    assert [r["alloc"] for r in a.step_log + b.step_log] == [r["alloc"] for r in u.step_log]
    assert ares["fault_log"] + bres["fault_log"] == ures["fault_log"]
    assert ares["memberships"] + bres["memberships"] == ures["memberships"]
    for key in ("steps", "epoch", "agg_index", "final_allocation", "gpus", "events_applied"):
        assert bres[key] == ures[key], key
    for x, y in zip(b.state["params"].parameters(), u.state["params"].parameters(), strict=True):
        assert torch.equal(x, y)
    for key in ("mu", "nu"):
        for x, y in zip(b.state["opt"][key], u.state["opt"][key], strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(b.state["step"]) == int(u.state["step"]) == STEPS


def test_model_cfg_and_the_checkpoint_log(tmp_path, uninterrupted):
    """A trainer handed the smoke configuration as ``model_cfg`` (not ``smoke``)
    trains at its ``max_seq`` as the smoke run does, and logs each save and
    restore with the checkpoint's bytes on disk."""
    u, _ = uninterrupted
    ck = str(tmp_path / "ck")
    run = dict(RUN, smoke=False, seq=64)
    a = ElasticTrainer(DriverConfig(**run, steps=4, ckpt_dir=ck, ckpt_every=2), model_cfg=smoke_config(ARCH, seq=SEQ))
    a.run()
    assert a.seq_len == SEQ and a.losses == u.losses[:4]
    assert [(r["op"], r["step"]) for r in a.ckpt_log] == [("save", 2), ("save", 4), ("save", 4)]
    size = sum(os.path.getsize(os.path.join(ck, "step_4", f)) for f in os.listdir(os.path.join(ck, "step_4")))
    assert a.ckpt_log[-1]["bytes"] == size > 0
    b = ElasticTrainer(DriverConfig(**run, steps=6, ckpt_dir=ck, ckpt_every=2, resume=True),
                       model_cfg=smoke_config(ARCH, seq=SEQ))
    assert b.ckpt_log == [{"op": "restore", "step": 4, "seconds": b.ckpt_log[0]["seconds"], "bytes": size}]
    b.run()
    assert b.losses == u.losses[4:6]


def test_resume_continues_a_reference_checkpoint(tmp_path, uninterrupted):
    """The reference's driver checkpoints at step 4; the port resumes from that
    directory with the reference's state, and its schedule goes on as an
    uninterrupted run's (simulated timing reads no model, so the allocation
    trajectory is the same whatever the weights)."""
    u, ures = uninterrupted
    ck = str(tmp_path / "ck")
    jtr = JElasticTrainer(JDriverConfig(**{k: v for k, v in RUN.items() if k != "device"}, steps=4, ckpt_dir=ck))
    jtr.run()
    tr = ElasticTrainer(DriverConfig(**RUN, steps=STEPS, ckpt_dir=ck, resume=True))
    assert tr.step_i == 4 and (tr.epoch, tr.agg_index) == (1, 1)
    want = train_state_from_jax(jax.tree.map(np.asarray, jtr.state), smoke_config(ARCH, seq=SEQ), device="cpu")
    for x, y in zip(tr.state["params"].parameters(), want["params"].parameters(), strict=True):
        assert torch.equal(x, y)
    tres = tr.run()
    for key in ("steps", "epoch", "agg_index", "final_allocation", "gpus", "events_applied"):
        assert tres[key] == ures[key], key
    assert [r["alloc"] for r in tr.step_log] == [r["alloc"] for r in u.step_log[4:]]
    assert tres["memberships"] == ures["memberships"]


@pytest.mark.parametrize("change,match", [
    (dict(policy="equal"), "policy"),
    (dict(hetero_gpus=None), "timing"),
    (dict(seed=7), "data stream"),
    (dict(events="add@5:v100"), "data stream"),
])
def test_resume_guards_refuse_another_run(tmp_path, change, match):
    ck = str(tmp_path / "ck")
    ElasticTrainer(DriverConfig(**RUN, steps=2, ckpt_dir=ck)).run()
    with pytest.raises(ValueError, match=match):
        ElasticTrainer(DriverConfig(**dict(RUN, **change), steps=4, ckpt_dir=ck, resume=True))


def test_checkpoint_metadata_carries_the_reference_s_fields(tmp_path):
    ck = str(tmp_path / "ck")
    ElasticTrainer(DriverConfig(**RUN, steps=3, ckpt_dir=ck)).run()
    with open(os.path.join(ck, "step_3", "meta.json")) as f:
        meta = json.load(f)["metadata"]
    assert set(meta) == {"controller", "epoch", "agg_index", "gpus", "alloc", "events_applied", "policy", "timing",
                         "data", "faults"}
    assert meta["data"]["events"] == ["slow@2:1*3~3", "replace@6:3=v100", "netdeg@7:2~2"]
    assert meta["faults"]["injector"]["slow"] == [{"worker": 1, "scale": 3.0, "from": 2, "until": 5}]


# ---------------------------------------------------------------------------
# the format, retention and the atomic write (tests/test_checkpoint.py's cases)
# ---------------------------------------------------------------------------


def _tree():
    return {
        "params": {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4), "b": np.ones(4, np.float16)},
        "opt": {"mu": [np.zeros((3, 4), np.float32), None], "count": np.int32(7)},
    }


def test_roundtrip_keeps_dtypes_and_reference_keys(tmp_path):
    t = _tree()
    d = str(tmp_path / "ck")
    save_pytree(d, t, metadata={"step": 3})
    with np.load(os.path.join(d, "arrays_p0.npz")) as npz:
        assert sorted(npz.files) == tree_paths(t) == ["opt/count", "opt/mu/[0]", "params/b", "params/w"]
    restored, meta = restore_pytree(d, t)
    assert meta == {"step": 3} and restored["opt"]["mu"][1] is None
    assert tree_paths(t) == jax_tree_paths(jax.tree.map(np.asarray, t))
    for key in ("w", "b"):
        assert restored["params"][key].dtype == t["params"][key].dtype
        np.testing.assert_array_equal(restored["params"][key], t["params"][key])
    assert restored["opt"]["count"] == 7 and restored["opt"]["count"].dtype == np.int32


def test_restore_rejects_mismatched_tree(tmp_path):
    t = _tree()
    d = str(tmp_path / "ck")
    save_pytree(d, t)
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree(d, {"params": {"w": np.zeros((3, 4), np.float32)}})
    bad = _tree()
    bad["params"]["w"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(d, bad)


def test_atomic_overwrite_never_corrupts(tmp_path):
    t = _tree()
    d = str(tmp_path / "ck")
    save_pytree(d, t, metadata={"v": 1})
    os.makedirs(d + ".tmp", exist_ok=True)  # a writer that crashed mid-write
    with open(os.path.join(d + ".tmp", "garbage"), "w") as f:
        f.write("partial")
    assert restore_pytree(d, t)[1] == {"v": 1}
    save_pytree(d, t, metadata={"v": 2})
    assert restore_pytree(d, t)[1] == {"v": 2}
    assert not os.path.exists(d + ".tmp")


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=10)
    t = _tree()
    assert mgr.latest_step() is None and mgr.restore_or_init(t)[0] == 0
    for step in (10, 20, 30):
        tt = dict(t, params=dict(t["params"], w=t["params"]["w"] + step))
        assert mgr.save_if_due(step, tt, metadata={"step": step})
    assert mgr.save_if_due(35, t) is None
    assert mgr.all_steps() == [20, 30]
    step, restored, meta = mgr.restore(t)
    assert step == 30 and meta["step"] == 30 and restored["params"]["w"].ravel()[0] == 30.0
