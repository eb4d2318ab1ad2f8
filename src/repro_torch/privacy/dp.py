"""Differential privacy for client updates: DP-SGD clip + noise, zCDP
ledger — the port of `repro/privacy/dp.py`.

The client-side mechanism (applied in core/local_update.py to the
per-round (tail, prompt) delta, BEFORE masking/upload):

    delta <- delta * min(1, C / ||delta||_2)          # global L2 clip
    delta <- delta + N(0, (z * C)^2 I)                # calibrated Gaussian

One release is rho = 1 / (2 z^2) zCDP; zCDP composes additively across
rounds and converts to (eps, delta) via eps = rho + 2 sqrt(rho ln(1/delta))
(Bun-Steinke'16). Per-client (local-model) guarantee against the
honest-but-curious server, with no subsampling amplification claimed.

The Gaussian draws come from an explicit `torch.Generator`; the JAX
package's `jax.random` draws cannot be reproduced, so parity tests inject
the same unit normals into both (`core.local_update.dp_clip_and_noise`).
The accountant is plain float64 arithmetic and equals the JAX package's
exactly; its state rides the engine checkpoint.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_map_with_path

DP_SEED = 97   # base seed domain for DP noise (disjoint from WIRE/MASK)


# ------------------------------------------------------------- mechanism
def clip_tree(tree, l2_clip: float):
    """Scale `tree` to global L2 norm <= l2_clip (no-op when under).
    Returns (clipped tree, pre-clip norm as a 0-dim f32 tensor)."""
    sq = sum(torch.sum(torch.square(x.float()))
             for _, x in tree_flatten(tree))
    norm = torch.sqrt(torch.clamp_min(sq, 1e-24))
    # tensor / tensor: `float / tensor` would multiply by a reciprocal
    factor = torch.clamp_max(
        torch.tensor(l2_clip, dtype=torch.float32, device=norm.device) / norm,
        1.0)
    return tree_map(lambda x: (x * factor).to(x.dtype), tree), norm


def gaussian_noise_tree(generator: torch.Generator, tree, stddev: float):
    """iid N(0, stddev^2) shaped like `tree`, drawn leaf by leaf in
    `jax.tree` order from `generator`."""
    draws = {path: stddev * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=torch.float32)
             for path, x in tree_flatten(tree)}
    return tree_map_with_path(lambda p, _: draws[p], tree)


# ------------------------------------------------------------- accounting
def rho_per_release(noise_multiplier: float) -> float:
    """zCDP cost of one Gaussian release at noise z * sensitivity."""
    if noise_multiplier <= 0:
        return math.inf
    return 1.0 / (2.0 * noise_multiplier ** 2)


def epsilon_from_rho(rho: float, delta: float) -> float:
    """Bun-Steinke zCDP -> (eps, delta) conversion."""
    if rho == 0:
        return 0.0
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


def calibrate_noise(epsilon: float, delta: float, rounds: int) -> float:
    """Noise multiplier z so `rounds` composed releases land at a total
    (epsilon, delta). Inverts eps = rho + 2 sqrt(rho L): sqrt(rho_total)
    = sqrt(L + eps) - sqrt(L), split evenly across rounds."""
    if epsilon <= 0:
        raise ValueError(f"target epsilon must be > 0, got {epsilon}")
    L = math.log(1.0 / delta)
    rho_total = (math.sqrt(L + epsilon) - math.sqrt(L)) ** 2
    rho_round = rho_total / max(1, rounds)
    return math.sqrt(1.0 / (2.0 * rho_round))


class PrivacyAccountant:
    """Additive zCDP ledger across rounds, checkpoint-exact."""

    def __init__(self, *, noise_multiplier: float, l2_clip: float,
                 delta: float = 1e-5):
        if noise_multiplier <= 0:
            raise ValueError("DP accounting needs noise_multiplier > 0 "
                             f"(got {noise_multiplier}); without noise no "
                             "finite epsilon exists")
        if l2_clip <= 0:
            raise ValueError(f"l2_clip must be > 0, got {l2_clip}")
        self.noise_multiplier = float(noise_multiplier)
        self.l2_clip = float(l2_clip)
        self.delta = float(delta)
        self.rho = 0.0
        self.releases = 0

    def spend(self, n_releases: int = 1) -> None:
        self.rho += n_releases * rho_per_release(self.noise_multiplier)
        self.releases += n_releases

    def epsilon(self, delta: float = None) -> float:
        return epsilon_from_rho(self.rho,
                                self.delta if delta is None else delta)

    def report(self) -> str:
        return (f"zCDP rho={self.rho:.6f} over {self.releases} release(s) "
                f"-> eps={self.epsilon():.3f} at delta={self.delta:g} "
                f"(z={self.noise_multiplier:g}, C={self.l2_clip:g})")

    # ------------------------------------------------------------ resume
    def state_dict(self) -> Dict[str, np.float64]:
        """Ledger state + mechanism params. rho/releases restore the
        ledger; the params are fingerprints validated on load."""
        return {"rho": np.float64(self.rho),
                "releases": np.float64(self.releases),
                "noise_multiplier": np.float64(self.noise_multiplier),
                "l2_clip": np.float64(self.l2_clip),
                "delta": np.float64(self.delta)}

    def load_state_dict(self, state: Mapping[str, np.ndarray]) -> None:
        for name in ("noise_multiplier", "l2_clip", "delta"):
            saved = float(np.asarray(state[name]))
            if saved != getattr(self, name):
                raise ValueError(
                    f"DP mechanism mismatch on resume: checkpoint "
                    f"{name}={saved} vs engine {getattr(self, name)} — the "
                    f"epsilon ledger would be invalid; rebuild with the "
                    f"original DP flags")
        self.rho = float(np.asarray(state["rho"]))
        self.releases = int(np.asarray(state["releases"]))
