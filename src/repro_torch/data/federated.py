"""Federated data pipeline: IID / Dirichlet non-IID partitioning (the
paper's Sec. 4.1 setting: 50 clients, Dirichlet alpha=0.1 for non-IID),
client selection, and stacking selected clients into the (K, n, ...) layout
the protocol vmaps/shards over.

Two layers:

  *_indices   — partition as per-client INDEX arrays into one shared base
                dataset.  This is what `fed.Population` stores: for
                N >> K clients only the sampled cohort is ever
                materialized, so a million-client population costs one
                dataset plus N small int arrays.
  *_partition — the original materialized form (list of per-client dict
                copies), now a thin wrapper over the index layer.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _pad_indices(idx: np.ndarray, per: int, n_total: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Pad/trim a client's index set to exactly `per` samples so the client
    axis stacks. A non-empty client resamples its OWN data; a client the
    Dirichlet draw left EMPTY falls back to `per` uniform draws from the
    whole dataset (an IID stand-in — its `sizes` weight stays 1, so
    weighted sampling and FedAvg barely count it)."""
    if len(idx) == 0:
        idx = rng.integers(0, n_total, size=per)
    elif len(idx) < per:
        idx = np.concatenate([idx, rng.choice(idx, per - len(idx))])
    else:
        idx = idx[:per]
    rng.shuffle(idx)
    return np.asarray(idx, dtype=np.int64)


def iid_indices(n: int, n_clients: int, *,
                seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """Uniform shuffle-and-slice. Returns (per-client index arrays,
    true pre-padding sizes)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    per = n // n_clients
    idx = [np.asarray(perm[i * per:(i + 1) * per], dtype=np.int64)
           for i in range(n_clients)]
    return idx, np.full((n_clients,), per, dtype=np.int64)


def dirichlet_indices(labels: np.ndarray, n_clients: int, *,
                      alpha: float = 0.1, seed: int = 0,
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Label-skewed non-IID split [Hsu et al. 2019] as index arrays.
    Every client is padded (by resampling its own data) to the same size so
    the client axis stacks; the returned `sizes` are the TRUE pre-padding
    per-client sample counts — the right FedAvg / weighted-sampling weights.
    """
    n = len(labels)
    classes = np.unique(labels)
    rng = np.random.default_rng(seed)
    per = n // n_clients

    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx_c, cuts)):
            client_idx[cid].extend(part.tolist())

    sizes = np.array([max(1, len(ci)) for ci in client_idx], dtype=np.int64)
    out = [_pad_indices(np.asarray(ci, dtype=np.int64), per, n, rng)
           for ci in client_idx]
    return out, sizes


def iid_partition(data: Dict[str, np.ndarray], n_clients: int, *,
                  seed: int = 0) -> List[Dict[str, np.ndarray]]:
    n = len(next(iter(data.values())))
    idx, _ = iid_indices(n, n_clients, seed=seed)
    return [{k: v[i] for k, v in data.items()} for i in idx]


def dirichlet_partition(data: Dict[str, np.ndarray], n_clients: int, *,
                        alpha: float = 0.1, seed: int = 0,
                        label_key: str = "labels") -> List[Dict[str, np.ndarray]]:
    """Label-skewed non-IID split [Hsu et al. 2019]. Every client is padded
    (by resampling its own data) to the same size so the client axis stacks."""
    idx, _ = dirichlet_indices(data[label_key], n_clients, alpha=alpha,
                               seed=seed)
    return [{k: v[i] for k, v in data.items()} for i in idx]


def select_clients(n_clients: int, k: int, *, seed: int, round_idx: int):
    rng = np.random.default_rng(seed * 100_003 + round_idx)
    return rng.choice(n_clients, size=k, replace=False)


def stack_clients(clients: Sequence[Dict[str, np.ndarray]],
                  idx: Sequence[int]) -> Dict[str, np.ndarray]:
    """-> pytree with leading (K, n_local, ...) axes."""
    keys = clients[0].keys()
    return {k: np.stack([clients[i][k] for i in idx]) for k in keys}
