"""Deterministic synthetic classification datasets for tests and benches
(the port's copy of `caffeonspark_tpu/data/synthetic.py`).

The reference's CI trains on a real MNIST LMDB fetched by
scripts/setup-mnist.sh (top Makefile:23); convergence checks here
(InterleaveTest.scala:53-55 analog) need no download and run on a
synthetic task of the same shape: 10 classes of HxW images, each class a distinct oriented-bar
pattern plus noise, linearly non-trivial but easily separable by a small
convnet."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def make_images(n: int, *, channels: int = 1, height: int = 28,
                width: int = 28, num_classes: int = 10, seed: int = 0,
                noise: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images[N,C,H,W] float32 in [0,1], labels[N] int32)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    imgs = np.zeros((n, channels, height, width), np.float32)
    for i, k in enumerate(labels):
        # oriented sinusoidal grating, angle & frequency indexed by class
        angle = np.pi * k / num_classes
        freq = 2.0 * np.pi * (2 + (k % 3)) / width
        phase = rng.uniform(0, 2 * np.pi)
        pat = 0.5 + 0.5 * np.sin(
            freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase)
        img = pat + noise * rng.randn(height, width).astype(np.float32)
        imgs[i] = np.clip(img, 0.0, 1.0)[None].repeat(channels, axis=0)
    return imgs, labels


def batches(n: int, batch_size: int, *, seed: int = 0, scale: float = 1.0,
            **kw) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Epoch-less generator of (data, label) batches; data pre-scaled the
    way transform_param.scale would (e.g. 1/256 for MNIST configs)."""
    imgs, labels = make_images(n, seed=seed, **kw)
    # emulate 8-bit storage so transform scale semantics are realistic
    imgs_u8 = (imgs * 255.0).astype(np.float32)
    i = 0
    while True:
        idx = np.arange(i, i + batch_size) % n
        yield imgs_u8[idx] * scale, labels[idx].astype(np.float32)
        i = (i + batch_size) % n
