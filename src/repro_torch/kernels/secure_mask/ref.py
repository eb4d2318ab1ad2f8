"""Plain PyTorch versions of the fused secure-aggregation mask op — the
port of `repro/kernels/secure_mask/ref.py`.

One client's secure upload is its trainable delta fixed-point-encoded into
the uint32 ring with the client's summed pairwise mask folded in:

    upload = encode(x) + sum_j sign_j * PRG(seed_j)      (mod 2^32)

The ring tensor is `int32` holding the uint32 bit pattern: PyTorch on the
CPU has no uint32 add, and a 4-byte type keeps the wire payload, the memory
and `==` against the JAX package's uint32 arrays (`.view(np.uint32)`) as
they are. Arithmetic runs in int64 on values in [0, 2^32) and is masked
with 0xFFFFFFFF; `to_ring` maps back exactly.

The PRG is the JAX reference's own: `jax.random.bits(PRNGKey(seed), (n,),
uint32)` is, element by element, `a ^ b` of threefry2x32-20 under key
(0, seed) at counter (i >> 32, i & 0xFFFFFFFF). `threefry2x32` transcribes
it, so the masked uploads equal the JAX reference's bit for bit; the CUDA
kernel computes the same stream per element.
"""
from __future__ import annotations

from typing import Tuple

import torch

FRAC_BITS = 16          # default fixed-point precision: ~1.5e-5 resolution
RING_EDGE = 2.0 ** 31   # signed-range boundary of the uint32 ring
# saturation bound: the largest f32 BELOW 2^31 — clipping at 2^31 - 1
# would round the bound up to exactly 2^31 in f32 and flip a saturated
# positive value into the negative ring half
SAT = RING_EDGE - 128
MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def to_ring(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same bit pattern."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def from_ring(u: torch.Tensor) -> torch.Tensor:
    """int32 ring tensor -> int64 values in [0, 2^32)."""
    return u.to(torch.int64) & MASK32


def encode(x: torch.Tensor, frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """float -> two's-complement fixed point in the ring (saturating);
    round half to even, as `jnp.round`."""
    q = torch.round(x.float() * (2.0 ** frac_bits))
    q = torch.clamp(q, -SAT, SAT)
    return q.to(torch.int32)


def decode(u: torch.Tensor, frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """Ring value -> f32, recentered (u >= 2^31 reads negative): the int32
    view is that recentered value, so this is one conversion and an exact
    power-of-two scale."""
    return u.to(torch.float32) / (2.0 ** frac_bits)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Tuple, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on int64 words in [0, 2^32); `key` is
    two ints or int64 tensors broadcastable against the counters."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def random_bits(key: Tuple, n: int, device=None) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` as int64 values: element i is
    a ^ b of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(key, i >> 32, i & MASK32)
    return a ^ b


def mask_stream(seed: int, n: int, device=None) -> torch.Tensor:
    """The (n,) PRG stream of one pairwise seed, as int64 in [0, 2^32)."""
    return random_bits((0, int(seed) & MASK32), n, device)


def _fold(acc: torch.Tensor, seeds, signs, n: int) -> torch.Tensor:
    for seed, sign in zip(torch.as_tensor(seeds).tolist(),
                          torch.as_tensor(signs).tolist()):
        if sign:
            acc = acc + sign * mask_stream(seed, n, acc.device)
    return to_ring(acc & MASK32)


def summed_mask(seeds, signs, n: int, device=None) -> torch.Tensor:
    """sum_j sign_j * PRG(seed_j) over the pair axis; (n,) int32 ring."""
    return _fold(torch.zeros((n,), dtype=torch.int64, device=device),
                 seeds, signs, n)


def masked_encode(x: torch.Tensor, seeds, signs,
                  frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """encode(x) + summed pairwise mask; (n,) int32 ring."""
    return _fold(from_ring(encode(x, frac_bits)), seeds, signs, x.shape[0])
