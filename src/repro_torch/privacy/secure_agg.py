"""Pluggable phase-3 aggregators: clear FedAvg vs masked secure aggregation
— the port of `repro/privacy/secure_agg.py`.

Both implement one contract the protocol calls:

    aggregate(client_trees, weights, fallback, round_idx)
        -> (aggregated tree, wire bytes dict)

`ClearAggregator` is `fedavg_partial`. `SecureAggregator` makes the same
round cryptographically blind:

  1. each client pre-scales its contribution by w_k / W (W, the survivors'
     total weight, cancels between encode and decode, so the decoded sum
     is `fedavg_partial`'s survivor-weighted mean),
  2. fixed-point encodes into the uint32 ring and adds its pairwise PRG
     masks in one fused pass (`kernels/secure_mask`: the CUDA kernel on
     the card, its plain version on the CPU),
  3. the server ring-sums the surviving uploads — pair masks between two
     survivors cancel mod 2^32,
  4. masks dangling toward dropped clients are regenerated from the
     escrowed pair seeds and subtracted (Bonawitz dropout recovery),
  5. an all-dropped round falls back to the pre-round globals.

The weights are known on the host, so the JAX package's `lax.cond` around
the recovery pass and its `where` around the fallback are host `if`s. Every
byte of the exchange crosses a runtime Boundary (RawCodec): simulated DH
pubkeys (PK_BYTES per client per peer), the uint32 uploads (RING_BYTES per
padded element, survivors only) and the seed reveals (SEED_BYTES per
survivor x dropped pair) — the counterpart of `comm.secure_agg_breakdown`.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import fedavg_partial
from repro_torch.kernels.secure_mask.ops import (FRAC_BITS, decode,
                                                 masked_encode, summed_mask)
from repro_torch.kernels.secure_mask.ref import MASK32, random_bits, to_ring
from repro_torch.privacy.fixed_point import flatten_tree, unflatten_tree
from repro_torch.privacy.masking import (PK_BYTES, SEED_BYTES, client_pairs,
                                         pair_seeds, recovery_pairs,
                                         round_key)
from repro_torch.runtime.boundary import Boundary
from repro_torch.runtime.codec import get_codec
from repro_torch.runtime.meter import SECURE


class ClearAggregator:
    """`fedavg_partial` behind the pluggable-aggregator contract. The
    empty wire dict tells the protocol to keep its (K + n_up) *
    param_bytes accounting."""

    name = "clear"

    def describe(self) -> str:
        return "clear"

    def aggregate(self, client_trees, weights: torch.Tensor, fallback,
                  round_idx) -> Tuple[Any, Dict[str, float]]:
        return fedavg_partial(client_trees, weights, fallback), {}


class SecureAggregator:
    """Masked secure aggregation over the fixed-point uint32 ring."""

    name = "secure"

    def __init__(self, *, frac_bits: int = FRAC_BITS, seed: int = 0):
        self.frac_bits = frac_bits
        self.seed = seed
        raw = get_codec("raw")
        self.params_boundary = Boundary("params", raw)
        self.secure_boundary = Boundary(SECURE, raw)

    def describe(self) -> str:
        return f"secure(frac_bits={self.frac_bits}, seed={self.seed})"

    def aggregate(self, client_trees, weights: torch.Tensor, fallback,
                  round_idx) -> Tuple[Any, Dict[str, np.float32]]:
        flat, paths, shapes, n_real = flatten_tree(client_trees)
        k, n_pad = flat.shape
        dev = flat.device
        w = torch.as_tensor(weights, dtype=torch.float32).cpu().numpy()
        total = w.sum(dtype=np.float32)
        alive = w > 0
        n_up = np.float32(alive.sum())
        # survivor-renormalized weights; W cancels encode->decode so using
        # the survivor total directly reproduces fedavg_partial's mean
        wn = torch.from_numpy(w / np.maximum(total, np.float32(1e-9)))
        scaled = flat * wn.to(dev)[:, None]

        rk = round_key(self.seed, round_idx)
        seeds = pair_seeds(rk, k)

        # ---- client side: fused encode + pairwise mask, K launches (the
        # dropped clients' too, as in the JAX package); survivors upload
        ring_sum = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
        for c in range(k):
            peers, signs = client_pairs(k, c)
            enc = masked_encode(scaled[c], seeds[c, peers], signs,
                                frac_bits=self.frac_bits)
            if alive[c]:
                ring_sum += enc.to(torch.int64) & MASK32

        # ---- server side: regenerate masks dangling toward dropped
        # clients from the escrowed seeds and subtract the residue, only
        # when a client actually dropped
        ri, rj = recovery_pairs(k)
        eff_signs = (np.sign(rj - ri).astype(np.int32)
                     * alive[ri].astype(np.int32)
                     * (1 - alive[rj].astype(np.int32)))
        if not alive.all():
            residue = summed_mask(seeds[ri, rj], eff_signs, n_pad,
                                  device=dev, frac_bits=self.frac_bits)
            ring_sum -= residue.to(torch.int64) & MASK32
        corrected = to_ring(ring_sum & MASK32)

        if total > 0:
            mean_flat = decode(corrected, self.frac_bits)
            agg = unflatten_tree(mean_flat, paths, shapes, n_real, fallback)
        else:
            agg = fallback

        # ---- wire: pubkey exchange (all K set up before dropouts), masked
        # uploads (survivors only), escrow reveals (survivor x dropped)
        pubkeys = random_bits(rk, k * k * (PK_BYTES // 4)).reshape(
            k * k, PK_BYTES // 4)
        _, b_pk = self.secure_boundary.transmit(pubkeys, train=False)
        _, b_up = self.params_boundary.transmit(
            corrected[None].expand(k, n_pad), train=False, rows=n_up)
        n_dropped = np.float32(k) - n_up
        reveal_payload = seeds[ri, rj].reshape(-1, 1)
        assert SEED_BYTES == 4  # one uint32 per revealed pair seed
        _, b_reveal = self.secure_boundary.transmit(
            reveal_payload, train=False, rows=n_up * n_dropped)
        return agg, {"params_up": b_up, SECURE: b_pk + b_reveal}
