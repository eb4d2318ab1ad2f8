"""Fixed-point uint32 ring codec for secure aggregation — the port of
`repro/privacy/fixed_point.py`.

Secure aggregation sums ciphertexts, so the plaintext arithmetic must be
EXACT and closed under addition — floats are neither. Client deltas are
carried as two's-complement fixed point in the uint32 ring (`frac_bits`
fractional bits, saturating encode), where pairwise masks add and cancel
mod 2^32. The ring tensor is int32 holding the uint32 bit pattern
(`kernels/secure_mask/ref.py`).

Range discipline: the server decodes only SUMS of client values, so every
client pre-scales its contribution by w_k / W; the headroom to the 2^31
edge is 2^(31 - frac_bits) in float units (~32768 at 16 bits).

`flatten_tree` / `unflatten_tree` fix the leaf order to `jax.tree`'s
(sorted dict keys, `tree.tree_flatten`), so the ring layout equals the JAX
package's, and pad to the kernel lane multiple (the pad is masked and
counted on the wire like real payload).
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.secure_mask.ops import (FRAC_BITS, decode,  # noqa: F401
                                                 encode, ring_size)
from repro_torch.kernels.secure_mask.ref import SAT
from repro_torch.tree import tree_flatten, tree_map_with_path

RING_BYTES = 4   # one uint32 per encoded element on the wire


def resolution(frac_bits: int = FRAC_BITS) -> float:
    """Smallest representable increment, in float units."""
    return 2.0 ** -frac_bits


def headroom(frac_bits: int = FRAC_BITS) -> float:
    """Largest encodable magnitude before saturation, in float units."""
    return SAT * resolution(frac_bits)


def roundtrip_tol(n_clients: int, frac_bits: int = FRAC_BITS) -> float:
    """Worst-case absolute error of a decoded n-client fixed-point sum vs
    the float computation: half an ulp of encode rounding per client plus
    one f32 conversion ulp each."""
    return (n_clients + 1) * (0.5 + 2.0 ** -7) * resolution(frac_bits)


def flatten_tree(tree: Any) -> Tuple[torch.Tensor, List, List, int]:
    """K-leading-axis tree -> (K, n_padded) f32 matrix + recovery info.
    Returns (flat, paths, shapes, n_real)."""
    pairs = tree_flatten(tree)
    k = pairs[0][1].shape[0]
    paths = [p for p, _ in pairs]
    shapes = [tuple(leaf.shape[1:]) for _, leaf in pairs]
    flat = torch.cat([leaf.reshape(k, -1).float() for _, leaf in pairs],
                     dim=1)
    n_real = flat.shape[1]
    pad = ring_size(n_real) - n_real
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, paths, shapes, n_real


def unflatten_tree(flat: torch.Tensor, paths, shapes, n_real: int,
                   like: Any) -> Any:
    """(n_padded,) vector -> tree shaped, dtyped and key-ordered like
    `like` (no K axis)."""
    flat = flat[:n_real]
    leaves, pos = {}, 0
    for path, shape in zip(paths, shapes):
        size = math.prod(shape)
        leaves[path] = flat[pos: pos + size].reshape(shape)
        pos += size
    return tree_map_with_path(lambda p, x: leaves[p].to(x.dtype), like)
