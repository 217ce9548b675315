"""Deterministic synthetic datasets (no download needed).

``make_image_dataset``: Fashion-MNIST-like (28x28x1, 10 classes) and
CIFAR-10-like (32x32x3, 10 classes) class-conditional data: per-class
smoothed templates + per-sample noise + random per-sample contrast.  A
numpy copy of ``repro.data.synthetic.make_image_dataset``: the same seed
gives the same arrays in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

@dataclasses.dataclass(frozen=True)
class ImageSpec:
    name: str
    height: int
    width: int
    channels: int
    num_classes: int = 10


FMNIST = ImageSpec("fashion-mnist-like", 28, 28, 1)
CIFAR10 = ImageSpec("cifar10-like", 32, 32, 3)


def _smooth(x: np.ndarray, iters: int = 8) -> np.ndarray:
    """Neighbor-averaging smoothing along H, W (keeps templates low-freq)."""
    for _ in range(iters):
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def make_image_dataset(spec: ImageSpec, n_train: int = 10_000,
                       n_test: int = 2_000, seed: int = 0,
                       noise: float = 0.35):
    """Returns (x_train, y_train, x_test, y_test) as numpy arrays.
    Images in [-1, 1]-ish, labels int32."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(
        size=(spec.num_classes, spec.height, spec.width, spec.channels))
    templates = np.stack([_smooth(t) for t in templates]).astype(np.float32)
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True)

    def sample(n):
        y = rng.integers(0, spec.num_classes, size=n).astype(np.int32)
        contrast = rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        x = templates[y] * contrast + noise * rng.normal(
            size=(n, spec.height, spec.width, spec.channels)).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return x_tr, y_tr, x_te, y_te
