"""The paper's own experiment models: ConvNet (MNIST), VGG-s / ResNet-s (CIFAR10)
(the port of ``repro.models.convnet``).

The paper validates convergence-invariance of task allocation on ConvNet,
VGG11/16/19 and ResNet18/50.  These are the reference's faithful-but-scaled
versions (channel widths scaled so the CPU benchmarks finish), as
``nn.Module`` classes.

Layout, stated once: every model takes the reference's NHWC batch
(B, H, W, C) and permutes it to NCHW for the convolutions; on the card the
permuted view of a contiguous NHWC batch is already ``channels_last``
memory, which cuDNN takes as it is (the CPU takes a contiguous copy,
:func:`_nchw`).  Convolution weights are OIHW (the reference's are HWIO;
``models.convert.convnet_params_from_jax`` transposes them), the dense
``fc`` is (d_in, n_classes) as in the reference (``x @ fc``).  The
convolutions are cuDNN's (MKL-DNN's on the CPU) and the products
``torch.matmul``: the reference runs them outside any Pallas kernel.

Where a straight translation would go wrong:

* ``"SAME"`` padding pads ``max((ceil(H/s) - 1)·s + k - H, 0)`` rows in
  all, the odd one at the END (XLA's rule): at stride 2 with a 3×3 kernel
  on 32 rows that is (0, 1), where torch's symmetric ``padding=1`` would
  give (1, 1).  :func:`_conv` pads asymmetric cases with ``F.pad``.
* ConvNet flattens before ``fc`` in NHWC order (h, w, c), as the reference
  does: the activation is permuted back to NHWC first, so ``fc``'s rows keep
  the reference's order.
* GroupNorm over contiguous channel groups, ``g = min(8, C)``, biased
  variance, eps 1e-5: ``F.group_norm``'s definition (held to the reference's
  ``_gn`` by the tests).
* Max pooling is VALID with k = 2: ``F.max_pool2d(x, 2)`` (floor).

Each model draws its own initial weights from a ``torch.Generator`` seeded
by ``seed`` on the CPU (a truncated normal at ±2, scaled as the reference's
``_conv_init``/``_dense_init``) and then moves them to ``device``, so the
same seed gives the same weights on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

__all__ = [
    "CONVNET_ARCHS",
    "ConvNet",
    "RESNET_PLANS",
    "ResNet",
    "VGG",
    "VGG_PLANS",
    "build_convnet",
    "xent_loss",
]

VGG_PLANS = {
    "vgg11s": (1, 1, 2, 2, 2),
    "vgg16s": (2, 2, 3, 3, 3),
    "vgg19s": (2, 2, 4, 4, 4),
}
RESNET_PLANS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}
CONVNET_ARCHS = ("convnet", *VGG_PLANS, "resnet18", "resnet50")


def _trunc_normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return nn.Parameter(w * std)


def _conv_init(kh: int, kw: int, cin: int, cout: int, gen: torch.Generator) -> nn.Parameter:
    return _trunc_normal((cout, cin, kh, kw), (2.0 / (kh * kw * cin)) ** 0.5, gen)


def _dense_init(din: int, dout: int, gen: torch.Generator) -> nn.Parameter:
    return _trunc_normal((din, dout), din**-0.5, gen)


def _same(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dimension: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW convolution with the reference's "SAME" padding."""
    (h0, h1), (w0, w1) = _same(x.shape[2], w.shape[2], stride), _same(x.shape[3], w.shape[3], stride)
    if h0 == h1 and w0 == w1:
        return F.conv2d(x, w, stride=stride, padding=(h0, w0))
    return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=stride)


def _gn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm stand-in for BatchNorm (batch-size independent: task
    allocation changes per-worker batch sizes)."""
    return F.group_norm(x, min(groups, x.shape[1]), gamma, beta, eps)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NHWC batch as NCHW: a ``channels_last`` view on the card; a
    contiguous copy on the CPU, where the backward of a strided 1×1
    convolution of a ``channels_last`` input (ResNet's projection) crashes
    torch's CPU kernels (seen in torch 2.13)."""
    if x.ndim != 4:
        raise ValueError(f"expected an NHWC batch (B, H, W, C), got shape {tuple(x.shape)}")
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


class ConvNet(nn.Module):
    """Paper §IV.B: 2 conv + 2 maxpool + 1 fc, MNIST (B, 28, 28, 1) -> (B, n_classes)."""

    def __init__(self, n_classes: int = 10, width: int = 16, in_ch: int = 1, *, seed: int = 0, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.c1 = _conv_init(5, 5, in_ch, width, gen)
        self.c2 = _conv_init(5, 5, width, 2 * width, gen)
        self.fc = _dense_init(2 * width * 7 * 7, n_classes, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(_conv(_nchw(x), self.c1)), 2)
        x = F.max_pool2d(F.relu(_conv(x, self.c2)), 2)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ self.fc  # NHWC flatten


class VGG(nn.Module):
    """VGG-s (CIFAR10, 32×32): blocks of 3×3 conv + GroupNorm + ReLU, a max
    pool after each block, global mean, fc."""

    def __init__(
        self, plan: str = "vgg11s", n_classes: int = 10, width: int = 16, in_ch: int = 3, *, seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.plan = plan
        gen = torch.Generator().manual_seed(seed)
        convs, gammas, betas = [], [], []
        cin = in_ch
        for bi, n in enumerate(VGG_PLANS[plan]):
            cout = width * (2 ** min(bi, 3))
            for _ in range(n):
                convs.append(_conv_init(3, 3, cin, cout, gen))
                gammas.append(nn.Parameter(torch.ones(cout)))
                betas.append(nn.Parameter(torch.zeros(cout)))
                cin = cout
        self.convs = nn.ParameterList(convs)
        self.gammas = nn.ParameterList(gammas)
        self.betas = nn.ParameterList(betas)
        self.fc = _dense_init(cin, n_classes, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        li = 0
        for n in VGG_PLANS[self.plan]:
            for _ in range(n):
                x = F.relu(_gn(_conv(x, self.convs[li]), self.gammas[li], self.betas[li]))
                li += 1
            x = F.max_pool2d(x, 2)
        return x.mean(dim=(2, 3)) @ self.fc


def _resnet_strides(depth: int) -> list[tuple[int, bool]]:
    """Static (stride, has_proj) schedule per block, derived from the plan."""
    out = []
    cin_mult = 1
    for si, n in enumerate(RESNET_PLANS[depth]):
        width_mult = 2**si
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            out.append((stride, stride != 1 or cin_mult != width_mult))
            cin_mult = width_mult
    return out


class _Block(nn.Module):
    """A basic block: conv, GN, ReLU, conv, GN, plus the (projected) shortcut."""

    def __init__(self, cin: int, cout: int, stride: int, has_proj: bool, gen: torch.Generator):
        super().__init__()
        self.stride = stride
        self.c1 = _conv_init(3, 3, cin, cout, gen)
        self.c2 = _conv_init(3, 3, cout, cout, gen)
        self.gn1_gamma, self.gn1_beta = nn.Parameter(torch.ones(cout)), nn.Parameter(torch.zeros(cout))
        self.gn2_gamma, self.gn2_beta = nn.Parameter(torch.ones(cout)), nn.Parameter(torch.zeros(cout))
        self.proj = _conv_init(1, 1, cin, cout, gen) if has_proj else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_gn(_conv(x, self.c1, self.stride), self.gn1_gamma, self.gn1_beta))
        h = _gn(_conv(h, self.c2), self.gn2_gamma, self.gn2_beta)
        sc = _conv(x, self.proj, self.stride) if self.proj is not None else x
        return F.relu(h + sc)


class ResNet(nn.Module):
    """ResNet-s (CIFAR10): depth 18 -> (2, 2, 2, 2) basic blocks, 50 -> (3, 4, 6, 3)."""

    def __init__(
        self, depth: int = 18, n_classes: int = 10, width: int = 16, in_ch: int = 3, *, seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.depth = depth
        gen = torch.Generator().manual_seed(seed)
        self.stem = _conv_init(3, 3, in_ch, width, gen)
        blocks = []
        cin = width
        sched = iter(_resnet_strides(depth))
        for si, n in enumerate(RESNET_PLANS[depth]):
            cout = width * (2**si)
            for _ in range(n):
                stride, has_proj = next(sched)
                blocks.append(_Block(cin, cout, stride, has_proj, gen))
                cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.fc = _dense_init(cin, n_classes, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_conv(_nchw(x), self.stem))
        for blk in self.blocks:
            x = blk(x)
        return x.mean(dim=(2, 3)) @ self.fc


def build_convnet(arch: str, *, n_classes: int = 10, width: int = 16, in_ch: int | None = None, seed: int = 0,
                  device="cuda") -> nn.Module:
    """One of ``CONVNET_ARCHS``: ``convnet`` (in_ch 1 by default), a
    ``VGG_PLANS`` name, ``resnet18`` or ``resnet50`` (in_ch 3)."""
    kw = dict(n_classes=n_classes, width=width, seed=seed, device=device)
    if arch == "convnet":
        return ConvNet(in_ch=1 if in_ch is None else in_ch, **kw)
    in_ch = 3 if in_ch is None else in_ch
    if arch in VGG_PLANS:
        return VGG(arch, in_ch=in_ch, **kw)
    if arch in ("resnet18", "resnet50"):
        return ResNet(int(arch[len("resnet"):]), in_ch=in_ch, **kw)
    raise ValueError(f"unknown convnet arch {arch!r}; expected one of {CONVNET_ARCHS}")


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()
