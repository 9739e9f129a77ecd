"""Synthetic-but-learnable image datasets standing in for MNIST and
Fashion-MNIST (this container is offline; no dataset downloads).

Construction mirrors the statistical character of the originals:
* `mnist_like`    — 10 classes, one smooth prototype each, small affine
                    jitter + pixel noise. Low intra-class variance → a
                    small CNN reaches high accuracy (like MNIST).
* `fashion_like`  — 10 classes, *three* prototypes per class drawn from a
                    shared texture bank, stronger jitter/noise and class
                    overlap → markedly harder (like Fashion-MNIST).

Everything is deterministic in the seed. Images are (28, 28, 1) float32
in [0, 1]; labels int32 in [0, 10).
"""
from __future__ import annotations

import numpy as np

IMAGE_SIZE = 28
NUM_CLASSES = 10


def _smooth_field(rng, size=IMAGE_SIZE, low=7):
    """Random smooth image: low-res gaussian field, bilinear-upsampled."""
    coarse = rng.normal(size=(low, low))
    idx = np.linspace(0, low - 1, size)
    x0 = np.floor(idx).astype(int)
    x1 = np.minimum(x0 + 1, low - 1)
    wx = idx - x0
    rows = (coarse[x0][:, x0] * (1 - wx)[None, :]
            + coarse[x0][:, x1] * wx[None, :])
    rows2 = (coarse[x1][:, x0] * (1 - wx)[None, :]
             + coarse[x1][:, x1] * wx[None, :])
    img = rows * (1 - wx)[:, None] + rows2 * wx[:, None]
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return img


def _make_prototypes(seed, per_class, bank_size=0):
    rng = np.random.default_rng(seed)
    protos = np.zeros((NUM_CLASSES, per_class, IMAGE_SIZE, IMAGE_SIZE))
    bank = [_smooth_field(rng) for _ in range(bank_size)] if bank_size else None
    for c in range(NUM_CLASSES):
        for p in range(per_class):
            base = _smooth_field(rng)
            if bank is not None:   # shared textures -> class overlap
                mix = bank[rng.integers(bank_size)]
                base = 0.65 * base + 0.35 * mix
            protos[c, p] = base
    return protos.astype(np.float32)


def _render(rng, protos, n, shift=2, noise=0.15, contrast_jitter=0.0):
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    per_class = protos.shape[1]
    pick = rng.integers(0, per_class, size=n)
    imgs = protos[labels, pick].copy()
    for i in range(n):
        dx, dy = rng.integers(-shift, shift + 1, size=2)
        imgs[i] = np.roll(np.roll(imgs[i], dx, axis=0), dy, axis=1)
        if contrast_jitter:
            g = 1.0 + contrast_jitter * rng.normal()
            imgs[i] = np.clip(imgs[i] * g, 0, 1)
    imgs += noise * rng.normal(size=imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs[..., None], labels


def mnist_like(seed=0, n_train=6000, n_test=1000):
    protos = _make_prototypes(seed=1234, per_class=1)
    rng = np.random.default_rng(seed)
    xtr, ytr = _render(rng, protos, n_train, shift=3, noise=0.30)
    xte, yte = _render(rng, protos, n_test, shift=3, noise=0.30)
    return {"train": (xtr, ytr), "test": (xte, yte), "name": "mnist-like"}


def fashion_like(seed=0, n_train=6000, n_test=1000):
    protos = _make_prototypes(seed=5678, per_class=2, bank_size=4)
    rng = np.random.default_rng(seed + 10_000)
    xtr, ytr = _render(rng, protos, n_train, shift=3, noise=0.18,
                       contrast_jitter=0.2)
    xte, yte = _render(rng, protos, n_test, shift=3, noise=0.18,
                       contrast_jitter=0.2)
    return {"train": (xtr, ytr), "test": (xte, yte), "name": "fashion-like"}


DATASETS = {"mnist": mnist_like, "fashion": fashion_like}
