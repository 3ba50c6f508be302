"""Synthetic datasets, numpy copies of ``repro.data.synthetic`` that draw
from ``np.random.RandomState`` in the same order (same seed, same arrays).

Image classification: each class c is a Gaussian prototype image; samples
are prototype + noise + per-sample gain and bias, so both of the paper's
factors exist by construction: Sampling Bias (``class_skew``, single-class
batches) and Intrinsic Image Difference (per-sample noise). Scales mirror
the paper's three regimes: mnist-like (28×28×1, 10 classes), cifar-like
(32×32×3, 10) and imagenet-like (64×64×3, 1000, downscaled).
"""
from __future__ import annotations

import numpy as np


def make_classification(seed: int, n: int, image_size: int, channels: int,
                        num_classes: int, noise: float = 0.35,
                        class_skew: float = 0.0, difficulty: float = 1.0,
                        class_spread: float = 0.0, proto_seed: int = 1234):
    """-> dict(images (n,H,W,C) f32, labels (n,) i32).

    ``class_spread`` > 0 makes later classes intrinsically harder (smaller
    prototype magnitude). ``proto_seed`` fixes the class prototypes
    independently of ``seed`` so different draws share one task."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState(proto_seed + 31 * num_classes + image_size)
    protos = prng.randn(num_classes, image_size, image_size, channels).astype(np.float32)
    protos /= np.sqrt(difficulty)
    if class_spread > 0:
        mags = 1.0 / (1.0 + class_spread * np.arange(num_classes)
                      / max(num_classes - 1, 1))
        protos *= mags[:, None, None, None].astype(np.float32)
    if class_skew > 0:
        w = np.exp(-class_skew * np.arange(num_classes))
        w /= w.sum()
        labels = rng.choice(num_classes, size=n, p=w)
    else:
        labels = rng.randint(0, num_classes, size=n)
    imgs = protos[labels] + noise * rng.randn(n, image_size, image_size, channels).astype(np.float32)
    # per-sample brightness/contrast jitter = intrinsic image difference
    gain = (1.0 + 0.2 * rng.randn(n, 1, 1, 1)).astype(np.float32)
    bias = (0.1 * rng.randn(n, 1, 1, 1)).astype(np.float32)
    imgs = imgs * gain + bias
    return {"images": imgs.astype(np.float32), "labels": labels.astype(np.int32)}


def mnist_like(seed=0, n=6000):
    return make_classification(seed, n, 28, 1, 10, noise=0.3)


def cifar_like(seed=0, n=6000):
    return make_classification(seed, n, 32, 3, 10, noise=0.5, difficulty=2.0)


def imagenet_like(seed=0, n=20000):
    return make_classification(seed, n, 64, 3, 1000, noise=0.5, difficulty=2.0)


# ---------------------------------------------------------------------------
# Fig.1 controlled experiments
# ---------------------------------------------------------------------------
def single_class_batches(seed: int, batch_size: int, num_classes: int = 10,
                         image_size: int = 32, channels: int = 3,
                         noise: float = 0.5, class_spread: float = 2.0):
    """One batch per class — maximal Sampling Bias (paper Fig. 1a)."""
    data = []
    for c in range(num_classes):
        rng = np.random.RandomState(seed + c)
        d = make_classification(seed + 1000 + c, batch_size * 4, image_size,
                                channels, num_classes, noise=noise,
                                class_spread=class_spread)
        idx = np.where(d["labels"] == c)[0]
        while len(idx) < batch_size:    # top up with fresh draws of class c
            extra = make_classification(rng.randint(1 << 30), batch_size * 4,
                                        image_size, channels, num_classes,
                                        noise=noise, class_spread=class_spread)
            d = {k: np.concatenate([d[k], extra[k]]) for k in d}
            idx = np.where(d["labels"] == c)[0]
        sel = idx[:batch_size]
        data.append({k: v[sel] for k, v in d.items()})
    return data


def iid_batches(seed: int, n_batches: int, per_class: int,
                num_classes: int = 10, image_size: int = 32, channels: int = 3,
                noise: float = 0.5):
    """n_batches batches, each with exactly ``per_class`` samples of every
    class in the SAME class order (paper Fig. 1b: i.i.d. batches differing
    only at pixels)."""
    out = []
    for b in range(n_batches):
        imgs, labels = [], []
        for c in range(num_classes):
            d = make_classification(seed + 7919 * b + c, per_class * num_classes * 5,
                                    image_size, channels, num_classes, noise=noise)
            idx = np.where(d["labels"] == c)[0][:per_class]
            if len(idx) != per_class:
                raise ValueError("raise n in make_classification")
            imgs.append(d["images"][idx])
            labels.append(d["labels"][idx])
        out.append({"images": np.concatenate(imgs),
                    "labels": np.concatenate(labels)})
    return out


def make_lm_tokens(seed: int, n_seqs: int, seq_len: int, vocab: int,
                   order: int = 2):
    """Markov token stream, learnable structure for LM training.
    -> {"tokens": (n_seqs, seq_len) int32}."""
    rng = np.random.RandomState(seed)
    # sparse transition table: each context maps to a few likely tokens
    n_ctx = 4096
    table = rng.randint(0, vocab, size=(n_ctx, 4))
    toks = rng.randint(0, vocab, size=(n_seqs, seq_len))
    ctx = rng.randint(0, n_ctx, size=n_seqs)
    for t in range(1, seq_len):
        choice = table[ctx, rng.randint(0, 4, size=n_seqs)]
        mask = rng.rand(n_seqs) < 0.8
        toks[:, t] = np.where(mask, choice, toks[:, t])
        ctx = (ctx * 31 + toks[:, t]) % n_ctx
    return {"tokens": toks.astype(np.int32)}
