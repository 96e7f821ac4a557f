"""The paper's ConvNet, VGG-s and ResNet-s in the port
(``repro_torch.models.convnet``) against the JAX package's
(``repro.models.convnet``): the same weights, carried by the converter,
give the same logits, loss and gradients (``jax.grad``) in float32, at
both parities of "SAME" padding at stride 2 (32×32: (0, 1); 33×33:
(1, 1)) and at ConvNet's 28×28."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import convnet as ref
from repro_torch.models import convnet
from repro_torch.models.convert import convnet_params_from_jax, convnet_params_to_jax

# max |port - reference| / max |reference| of the logits and of each gradient, float32 (measured at most 4e-6)
RTOL = 1e-5
WIDTH, BATCH = 8, 4


def _reference(arch: str):
    """(init, forward) of the JAX package's model of ``arch``, at width 8."""
    if arch == "convnet":
        return (lambda k: ref.init_convnet(k, width=WIDTH)), ref.convnet_forward
    if arch in ref.VGG_PLANS:
        return (lambda k: ref.init_vgg(k, plan=arch, width=WIDTH)), (lambda p, x: ref.vgg_forward(p, x, arch))
    depth = int(arch[len("resnet"):])
    return (lambda k: ref.init_resnet(k, depth=depth, width=WIDTH)), (lambda p, x: ref.resnet_forward(p, x, depth))


CASES = [("convnet", 28)] + [(arch, h) for arch in convnet.CONVNET_ARCHS[1:] for h in (32, 33)]


@pytest.mark.parametrize("arch, size", CASES, ids=[f"{a}-{h}" for a, h in CASES])
def test_forward_loss_and_grads_equal_the_reference(arch, size):
    init, fwd = _reference(arch)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(size)
    x = rng.normal(size=(BATCH, size, size, 1 if arch == "convnet" else 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    ref_logits = np.asarray(fwd(tree, jnp.asarray(x)))
    ref_loss, ref_grads = jax.value_and_grad(lambda p: ref.xent_loss(fwd(p, jnp.asarray(x)), jnp.asarray(y)))(tree)

    model = convnet.build_convnet(arch, width=WIDTH, device="cpu")
    model.load_state_dict(convnet_params_from_jax(tree, arch))
    logits = model(torch.from_numpy(x))
    loss = convnet.xent_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert logits.shape == (BATCH, 10)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0, atol=RTOL * np.abs(ref_logits).max())
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=RTOL)
    grads = convnet_params_to_jax({k: p.grad for k, p in model.named_parameters()}, arch)
    flat_ref, flat = jax.tree.leaves(ref_grads), jax.tree.leaves(grads)
    assert len(flat) == len(flat_ref) == len(list(model.parameters()))
    for g, want in zip(flat, flat_ref):
        want = np.asarray(want)
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("arch", convnet.CONVNET_ARCHS)
def test_converter_round_trip_and_layouts(arch):
    init, _ = _reference(arch)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    state = convnet_params_from_jax(tree, arch)
    model = convnet.build_convnet(arch, width=WIDTH, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    back = convnet_params_to_jax(model.state_dict(), arch)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # HWIO -> OIHW; the dense fc as it is
    first = "c1" if arch == "convnet" else "convs.0" if arch.startswith("vgg") else "stem"
    leaf = tree["c1"] if arch == "convnet" else tree["convs"][0] if arch.startswith("vgg") else tree["stem"]
    assert np.array_equal(state[first].numpy(), leaf.transpose(3, 2, 0, 1))
    assert np.array_equal(state["fc"].numpy(), tree["fc"])
    with pytest.raises(ValueError):
        convnet_params_to_jax({**model.state_dict(), "extra": torch.zeros(1)}, arch)


def test_same_padding_is_xlas_at_both_parities():
    assert convnet._same(32, 3, 2) == (0, 1) and convnet._same(33, 3, 2) == (1, 1)
    assert convnet._same(32, 1, 2) == (0, 0) and convnet._same(28, 5, 1) == (2, 2)
    x = torch.randn(2, 3, 32, 32)
    w = torch.randn(4, 3, 3, 3)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(w.permute(2, 3, 1, 0).numpy()), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = convnet._conv(x, w, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    symmetric = torch.nn.functional.conv2d(x, w, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(symmetric - np.asarray(want)).max() > 1e-2  # torch's padding=1 is another function


def test_group_norm_is_the_references_gn():
    x = torch.randn(3, 24, 5, 7)
    gamma, beta = torch.randn(24), torch.randn(24)
    want = ref._gn(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()))
    got = convnet._gn(x, gamma, beta).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    four = torch.randn(2, 4, 3, 3)  # g = min(8, C): one channel a group
    np.testing.assert_allclose(
        convnet._gn(four, torch.ones(4), torch.zeros(4)).permute(0, 2, 3, 1).numpy(),
        np.asarray(ref._gn(jnp.asarray(four.permute(0, 2, 3, 1).numpy()), jnp.ones(4), jnp.zeros(4))),
        rtol=1e-5, atol=1e-5)


def test_init_is_seeded_device_independent_and_scaled():
    a = convnet.ResNet(18, width=WIDTH, seed=3, device="cpu")
    b = convnet.ResNet(18, width=WIDTH, seed=3, device="cpu")
    c = convnet.ResNet(18, width=WIDTH, seed=4, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.stem, c.stem)
    big = convnet.ConvNet(width=64, seed=0, device="cpu")
    std = (2.0 / (5 * 5 * 64)) ** 0.5
    assert big.c2.abs().max() <= 2 * std + 1e-7
    assert abs(big.c2.std().item() / std - 0.88) < 0.02  # a standard normal truncated at ±2 has std 0.880
    assert [s for s, _ in convnet._resnet_strides(50)] == [1, 1, 1, 2, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1]
    assert convnet._resnet_strides(50) == ref._resnet_strides(50)
    with pytest.raises(ValueError):
        convnet.build_convnet("vgg13s", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA card (this host has one)")
        convnet.ConvNet()


def test_sgd_steps_equal_the_reference():
    """The paper_figs ConvNet loop, 3 steps of momentum SGD at lr 0.01 with
    weight decay 1e-4: the same losses and weights."""
    from repro.data import SyntheticImages as RefImages
    from repro.optim import SGDConfig as RefSGDConfig
    from repro.optim import sgd_init as ref_sgd_init
    from repro.optim import sgd_update as ref_sgd_update
    from repro_torch.data import SyntheticImages
    from repro_torch.optim import SGDConfig, sgd_init, sgd_update

    tree = jax.tree.map(np.asarray, ref.init_convnet(jax.random.PRNGKey(0), width=WIDTH))
    model = convnet.ConvNet(width=WIDTH, device="cpu")
    model.load_state_dict(convnet_params_from_jax(tree, "convnet"))
    params = list(model.parameters())
    opt, ref_opt = sgd_init(params), ref_sgd_init(tree)
    data, ref_data = SyntheticImages(shape=(28, 28, 1), n_samples=512), RefImages(shape=(28, 28, 1), n_samples=512)
    p = tree
    for step in range(3):
        idx = np.arange(step * 100, (step + 1) * 100)
        b, rb = data.batch(idx), ref_data.batch(idx)
        assert np.array_equal(b["images"], rb["images"])
        x, y = jnp.asarray(rb["images"]), jnp.asarray(rb["labels"])
        ref_loss, g = jax.value_and_grad(lambda q: ref.xent_loss(ref.convnet_forward(q, x), y))(p)
        p, ref_opt = ref_sgd_update(g, ref_opt, p, 0.01, RefSGDConfig(momentum=0.9, weight_decay=1e-4))
        loss = convnet.xent_loss(model(torch.from_numpy(b["images"])), torch.from_numpy(b["labels"]))
        sgd_update(torch.autograd.grad(loss, params), opt, params, 0.01, SGDConfig(momentum=0.9, weight_decay=1e-4))
        np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=RTOL)
    for got, want in zip(jax.tree.leaves(convnet_params_to_jax(model.state_dict(), "convnet")),
                         jax.tree.leaves(jax.tree.map(np.asarray, p))):
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())
