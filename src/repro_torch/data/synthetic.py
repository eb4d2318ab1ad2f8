"""Synthetic datasets (the container is offline — DESIGN.md §Notes).

Image tasks: class-conditional Gaussian clusters in patch space with
class-dependent spatial structure — learnable by a ViT, so accuracy curves
separate methods the way the paper's CIFAR/SVHN/Flower curves do
(trend-level validation).

LM tasks: a Zipf unigram base with class-style "domain" prefixes and a
deterministic bigram drift per domain — enough structure for a small LM to
reduce CE visibly within a few hundred steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

PATCH = 16


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    image_hw: int = 224
    difficulty: float = 1.0   # cluster separation divisor (higher = harder)


# stand-ins for the paper's four downstream tasks
DATASETS: Dict[str, DatasetSpec] = {
    "cifar10-syn": DatasetSpec("cifar10-syn", 10, 224, 1.0),
    "cifar100-syn": DatasetSpec("cifar100-syn", 100, 224, 1.2),
    "svhn-syn": DatasetSpec("svhn-syn", 10, 224, 1.6),
    "flower102-syn": DatasetSpec("flower102-syn", 102, 224, 1.4),
}


def synthetic_image_dataset(spec: DatasetSpec, n: int, *, seed: int = 0,
                            image_hw: int | None = None):
    """Returns {'patches': (n, P, PATCH*PATCH*3) f32, 'labels': (n,) i32}.
    Pre-patchified (the ViT patch projection is part of the model head)."""
    rng = np.random.default_rng(seed)
    hw = image_hw or spec.image_hw
    n_patches = (hw // PATCH) ** 2
    pdim = PATCH * PATCH * 3
    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    # class anchors: low-rank structure + per-patch positional signature
    rank = 8
    class_basis = rng.normal(size=(spec.n_classes, rank)).astype(np.float32)
    mix = rng.normal(size=(rank, n_patches, pdim)).astype(np.float32)
    anchors = np.einsum("cr,rpd->cpd", class_basis, mix) / np.sqrt(rank)
    noise = rng.normal(size=(n, n_patches, pdim)).astype(np.float32)
    patches = anchors[labels] / spec.difficulty + 0.6 * noise
    return {"patches": patches.astype(np.float32), "labels": labels}


def synthetic_lm_dataset(n: int, seq_len: int, vocab: int, *, seed: int = 0,
                         n_domains: int = 8):
    """Returns {'tokens': (n, seq_len) i32} with per-domain bigram drift."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=(n, seq_len)).astype(np.int64)
    dom = rng.integers(0, n_domains, size=(n, 1))
    drift = (np.arange(seq_len)[None, :] * (dom + 1)) % 17
    toks = (base + drift) % vocab
    toks[:, 0] = dom[:, 0] % vocab  # domain marker token
    return {"tokens": toks.astype(np.int32)}
