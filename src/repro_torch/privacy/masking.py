"""Pairwise PRG masking (Bonawitz et al., CCS'17 — simplified) — the port
of `repro/privacy/masking.py`.

Client k's upload is blinded with one PRG stream per cohort peer:

    upload_k = encode(x_k) + sum_{j != k} sign(k, j) * PRG(s_kj)

with sign(k, j) = +1 for j > k and -1 for j < k and s_kj = s_jk, so in the
cohort SUM every pair cancels mod 2^32. Key agreement is SIMULATED: pair
seeds derive from a per-round key; seeds are ESCROWED so the server can
regenerate the masks dangling toward a dropped client.

The round key and the pair seeds are the JAX package's own:
`round_key` is `fold_in(PRNGKey(seed ^ MASK_SEED), round)` = threefry2x32
of (0, round) under key (0, seed ^ MASK_SEED), both output words forming
the new key; `pair_seeds` is `jax.random.bits(key, (K, K))` under it. Both
run in the plain threefry of `kernels/secure_mask/ref.py` on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.secure_mask.ref import (MASK32, random_bits,
                                                 threefry2x32)

MASK_SEED = 41   # base PRNG domain for per-round pairwise seeds
PK_BYTES = 32    # simulated DH public key size (key-agreement traffic)
SEED_BYTES = 4   # one uint32 pair seed (escrow-reveal traffic)


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a non-negative seed: (hi, lo) words."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)`: threefry of counter (0, data)."""
    a, b = threefry2x32(key, torch.tensor(0, dtype=torch.int64),
                        torch.tensor(int(data) & MASK32, dtype=torch.int64))
    return int(a), int(b)


def round_key(seed: int, round_idx) -> Tuple[int, int]:
    """Per-round masking key."""
    return fold_in(prng_key(seed ^ MASK_SEED), int(round_idx))


def pair_seeds(round_key: Tuple[int, int], k: int) -> torch.Tensor:
    """(K, K) symmetric pair-seed matrix (int64 holding uint32 values),
    zero diagonal, derived from the round key."""
    raw = random_bits(round_key, k * k).reshape(k, k)
    i = torch.arange(k)[:, None]
    j = torch.arange(k)[None, :]
    sym = torch.where(i < j, raw, raw.T)
    return torch.where(i == j, torch.zeros_like(sym), sym)


def pair_signs(k: int) -> np.ndarray:
    """(K, K) int32 antisymmetric sign matrix: +1 above the diagonal."""
    i = np.arange(k)[:, None]
    j = np.arange(k)[None, :]
    return np.sign(j - i).astype(np.int32)


def client_pairs(k: int, client: int):
    """Static (peers, signs) for one client's K-1 mask streams."""
    peers = np.array([j for j in range(k) if j != client], dtype=np.int64)
    signs = pair_signs(k)[client, peers]
    return peers, signs


def recovery_pairs(k: int):
    """All (i, j) ordered pairs as index arrays for the server's dropout
    correction: residue = sum_{i,j} alive_i * (1-alive_j) * sign(i,j)
    * PRG(s_ij)."""
    i = np.repeat(np.arange(k), k)
    j = np.tile(np.arange(k), k)
    keep = i != j
    return i[keep], j[keep]
