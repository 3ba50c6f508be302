"""The paper's benchmark CNNs (LeNet / CIFAR-quick / AlexNet-class).

Port of ``repro.models.cnn``. The loss is the paper's Eq. 6: softmax cross
entropy + (λ/2)·‖w‖² over every parameter, biases included, inside ψ, so
the ISGD control limit sees the quantity the paper monitors. It runs in
f32, as the reference does; on the card the caller keeps TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) where it compares with f32.

Layouts. Images arrive NHWC, as the JAX package takes them; the module
computes in NCHW through the permuted view (which is channels-last in
memory), with conv weights in PyTorch's (out, in, kh, kw) order and dense
weights as (in, out) for ``x @ W``. Before the first dense layer the
activation is flattened in H, W, C order, as JAX flattens NHWC, so the
first dense weight is the JAX one unpermuted (``convert.cnn_from_jax``
permutes only the conv weights).

``padding="SAME"`` in JAX pads ``total = max((ceil(n/s)−1)·s + k − n, 0)``
with ``total // 2`` before and the rest after, asymmetric when ``total`` is
odd, which neither ``nn.Conv2d`` nor ``F.max_pool2d`` can express; the
forward pads explicitly, with zeros before a convolution and −inf before a
max pool (``reduce_window(-inf, max)``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_cnns import CNNConfig
from repro_torch.device import resolve_device


def same_pad(n: int, k: int, s: int) -> tuple:
    """JAX's SAME padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def feature_size(cfg: CNNConfig) -> int:
    """Spatial size after the conv stack (ceil per stride, as SAME gives)."""
    size = cfg.image_size
    for c in cfg.convs:
        size = -(-size // c.stride)
        if c.pool:
            size = -(-size // c.pool_stride)
    return size


class CNN(nn.Module):
    """``convs[i]`` holds ``w`` (out, in, k, k) and ``b``; ``dense[i]``
    holds ``w`` (in, out) and ``b``. Parameters are f32 on ``device``."""

    def __init__(self, cfg: CNNConfig, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=dev, dtype=dtype)
        self.convs = nn.ModuleList()
        cin = cfg.channels
        for c in cfg.convs:
            m = nn.Module()
            m.w = nn.Parameter(torch.zeros((c.features, cin, c.kernel,
                                            c.kernel), **kw))
            m.b = nn.Parameter(torch.zeros((c.features,), **kw))
            self.convs.append(m)
            cin = c.features
        feat = feature_size(cfg) ** 2 * cin
        dims = (feat,) + tuple(cfg.hidden) + (cfg.num_classes,)
        self.dense = nn.ModuleList()
        for i in range(len(dims) - 1):
            m = nn.Module()
            m.w = nn.Parameter(torch.zeros((dims[i], dims[i + 1]), **kw))
            m.b = nn.Parameter(torch.zeros((dims[i + 1],), **kw))
            self.dense.append(m)


def init_cnn(module: CNN, seed: int = 0) -> CNN:
    """Fill ``module`` from a ``torch.Generator`` seeded with ``seed``:
    conv weights normal·1/√(k²·c_in), dense weights normal·1/√fan_in,
    biases zero; the reference's scales, not its draws (tests carry JAX
    weights over with ``repro_torch.convert``)."""
    w0 = module.convs[0].w if len(module.convs) else module.dense[0].w
    gen = torch.Generator(device=w0.device).manual_seed(seed)
    with torch.no_grad():
        for m in list(module.convs) + list(module.dense):
            fan_in = m.w[0].numel() if m.w.dim() == 4 else m.w.shape[0]
            m.w.copy_(torch.randn(m.w.shape, generator=gen,
                                  dtype=torch.float32, device=m.w.device)
                      / math.sqrt(fan_in))
            m.b.zero_()
    return module


def cnn_logits(module: CNN, images):
    """images: (B, H, W, C) -> (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    for spec, p in zip(module.cfg.convs, module.convs):
        ph = same_pad(x.shape[2], spec.kernel, spec.stride)
        pw = same_pad(x.shape[3], spec.kernel, spec.stride)
        x = F.pad(x, (*pw, *ph))
        x = F.relu(F.conv2d(x, p.w, p.b, stride=spec.stride))
        if spec.pool:
            ph = same_pad(x.shape[2], spec.pool, spec.pool_stride)
            pw = same_pad(x.shape[3], spec.pool, spec.pool_stride)
            x = F.pad(x, (*pw, *ph), value=float("-inf"))
            x = F.max_pool2d(x, spec.pool, spec.pool_stride)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC order
    n = len(module.dense)
    for i, p in enumerate(module.dense):
        x = x @ p.w + p.b
        if i < n - 1:
            x = F.relu(x)
    return x


def l2_sum(module: CNN):
    """Σ‖w‖² over every leaf, in the JAX tree's leaf order (convs then
    dense, ``b`` before ``w`` in each)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=module.dense[0].w.device)
    for m in list(module.convs) + list(module.dense):
        total = total + torch.sum(torch.square(m.b))
        total = total + torch.sum(torch.square(m.w))
    return total


def cnn_loss_fn(module: CNN, batch, weight_decay: float = 1e-4):
    """Paper Eq. 6: (cross entropy + (λ/2)‖w‖², cross entropy)."""
    logits = cnn_logits(module, batch["images"])
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    ce = (lse - gold).mean()
    return ce + 0.5 * weight_decay * l2_sum(module), ce


@torch.no_grad()
def cnn_accuracy(module: CNN, images, labels, batch: int = 1000) -> float:
    n = images.shape[0]
    correct = 0
    for i in range(0, n, batch):
        lg = cnn_logits(module, images[i:i + batch])
        correct += int((torch.argmax(lg, -1) == labels[i:i + batch]).sum())
    return correct / n
