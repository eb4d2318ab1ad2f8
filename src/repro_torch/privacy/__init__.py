"""Privacy engine: masked secure aggregation + DP-metered rounds — the
port of `repro/privacy/`.

  fixed_point.py — uint32-ring fixed-point codec + tree<->ring plumbing
  masking.py     — pairwise PRG seeds/signs (the JAX package's threefry
                   seeds), simulated key agreement, escrowed-seed recovery
  secure_agg.py  — ClearAggregator / SecureAggregator: the pluggable
                   phase-3 aggregation
  dp.py          — DP-SGD clip + Gaussian noise on client deltas, zCDP
                   PrivacyAccountant checkpointed through the engine
"""
from repro_torch.privacy.dp import (PrivacyAccountant,  # noqa: F401
                                    calibrate_noise, clip_tree,
                                    gaussian_noise_tree)
from repro_torch.privacy.secure_agg import (ClearAggregator,  # noqa: F401
                                            SecureAggregator)
