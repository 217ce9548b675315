"""Deterministic synthetic datasets (no download needed).

``make_image_dataset``: Fashion-MNIST-like (28x28x1, 10 classes) and
CIFAR-10-like (32x32x3, 10 classes) class-conditional data: per-class
smoothed templates + per-sample noise + random per-sample contrast.
``dirichlet_shards``: the federated edges' non-IID index partition.
``lm_batches``: token batches with planted bigram structure;
``serving_requests``: prompts and generation budgets.  Numpy copies of
``repro.data.synthetic``: the same seed gives the same values in both
packages (LM tokens as int32 torch tensors on the CPU).
``stub_embeddings``: the stubbed frontends' inputs (an audio model's
``frames``, a VLM's ``patches``), drawn on the device; parity tests give
both packages the same numpy arrays instead.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


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


def dirichlet_shards(labels, num_shards: int, *, alpha: float = 0.3,
                     seed: int = 0, min_per_shard: int = 1):
    """Deterministic non-IID partition of a labeled dataset: every
    class's sample indices are split across shards by Dirichlet(alpha)
    proportions (small alpha -> each shard dominated by a few classes —
    the federated heterogeneity the FL-MoE papers benchmark on).

    Returns a list of ``num_shards`` sorted int64 index arrays that
    exactly partition ``range(len(labels))``; identical across runs for
    the same (labels, num_shards, alpha, seed).  Shards that the draw
    left below ``min_per_shard`` samples steal from the largest shard so
    every edge can train."""
    labels = np.asarray(labels)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    rng = np.random.default_rng(seed)
    shards: list = [[] for _ in range(num_shards)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_shards, alpha))
        counts = np.floor(props * len(idx)).astype(int)
        order = np.argsort(-props, kind="stable")
        counts[order[:len(idx) - counts.sum()]] += 1
        off = 0
        for s in range(num_shards):
            shards[s].extend(idx[off:off + counts[s]].tolist())
            off += counts[s]
    out = [np.asarray(sorted(ids), dtype=np.int64) for ids in shards]
    for s in range(num_shards):
        while len(out[s]) < min(min_per_shard, len(labels) // num_shards):
            donor = int(np.argmax([len(a) for a in out]))
            out[s] = np.sort(np.append(out[s], out[donor][-1]))
            out[donor] = out[donor][:-1]
    return out


def lm_batches(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
               p_structured: float = 0.8) -> Iterator[dict]:
    """Infinite iterator of {tokens, labels} with planted bigram structure."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab_size)
    while True:
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        for t in range(seq):
            structured = rng.random(batch) < p_structured
            nxt = np.where(structured, perm[toks[:, t]],
                           rng.integers(0, vocab_size, size=batch))
            toks[:, t + 1] = nxt
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()),
               "labels": torch.from_numpy(toks[:, 1:].copy())}


def serving_requests(vocab_size: int, num_requests: int, *,
                     max_prompt: int = 64, max_new: int = 16,
                     seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    for rid in range(num_requests):
        plen = int(rng.integers(4, max_prompt))
        yield {"id": rid,
               "prompt": rng.integers(0, vocab_size, size=plen).astype(np.int32),
               "max_new_tokens": int(rng.integers(1, max_new))}


def stub_embeddings(batch: int, length: int, d_model: int, *, seed: int = 0,
                    device=None) -> torch.Tensor:
    """(batch, length, d_model) float32 standard-normal embeddings from a
    ``torch.Generator`` seeded with ``seed``, drawn on ``device``
    (``None``: the CUDA device): the encoder-decoder's ``frames`` or a
    VLM's ``patches`` prefix, which stand in for the stubbed audio and
    vision frontends."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((batch, length, d_model), generator=gen,
                       dtype=torch.float32, device=dev)
