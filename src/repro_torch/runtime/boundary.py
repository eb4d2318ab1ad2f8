"""Wire boundaries: the two physical links of the three-way split.

    client ──(head_body)──> server ──(body_tail)──> client

`Boundary.transmit` is THE function every smashed tensor crosses on its way
between segments. It applies the codec roundtrip (whose backward also
quantizes the gradient) and returns the exact byte count that hit the wire.

Byte counts are IEEE float32 scalars (numpy), computed with the same f32
operations as the JAX package's traced scalars, so the meter totals of the
two packages compare with ==. Every count is known on the host from shapes
and row counts, so it never waits on the device.

`WireSpec` bundles the two boundaries; `SplitModel` owns one and routes
`forward()` and serving through it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.codec import WireCodec, get_codec

HEAD_BODY = "head_body"
BODY_TAIL = "body_tail"
BOUNDARY_NAMES = (HEAD_BODY, BODY_TAIL)


@dataclass(frozen=True)
class Boundary:
    name: str
    codec: WireCodec

    def _noise(self, generator: Optional[torch.Generator], shape, device):
        if generator is None or not self.codec.stochastic:
            # round-to-nearest: deterministic — the eval/serving mode. The
            # noise stays a 0-dim scalar all the way into the kernel.
            half = torch.full((), 0.5, dtype=torch.float32, device=device)
            return half, half
        return (torch.rand(shape, generator=generator, device=device),
                torch.rand(shape, generator=generator, device=device))

    def transmit(self, x: torch.Tensor, *, generator=None, train: bool = True,
                 rows=None) -> Tuple[torch.Tensor, np.float32]:
        """Push `x` across this boundary. Returns (received tensor, wire
        bytes as an f32 scalar). `train=True` counts the backward gradient
        crossing too (same shape, same codec, opposite direction).

        `rows` (optional): number of leading-axis rows that actually cross
        the wire. A continuous-batching decode step runs all cache slots but
        only transmits the occupied ones — bytes then count
        `rows * payload_nbytes(one row)` instead of the full tensor."""
        u_fwd, u_bwd = self._noise(generator, x.shape, x.device)
        y = self.codec.roundtrip(x, u_fwd, u_bwd)
        direction = 2 if train else 1
        if rows is None:
            nbytes = np.float32(self.codec.payload_nbytes(tuple(x.shape))
                                * direction)
        else:
            per_row = self.codec.payload_nbytes((1,) + tuple(x.shape[1:]))
            nbytes = np.float32(rows) * np.float32(per_row * direction)
        return y, nbytes

    def payload_nbytes(self, shape) -> int:
        return self.codec.payload_nbytes(shape)


@dataclass(frozen=True)
class WireSpec:
    """The split's two cut points with their codecs."""
    head_body: Boundary
    body_tail: Boundary

    @classmethod
    def make(cls, codec: str = "fp32", *,
             body_tail_codec: Optional[str] = None) -> "WireSpec":
        c_hb = get_codec(codec)
        c_bt = get_codec(body_tail_codec or codec)
        return cls(head_body=Boundary(HEAD_BODY, c_hb),
                   body_tail=Boundary(BODY_TAIL, c_bt))

    @property
    def boundaries(self) -> Tuple[Boundary, Boundary]:
        return (self.head_body, self.body_tail)

    def describe(self) -> str:
        return (f"{HEAD_BODY}:{self.head_body.codec.name} "
                f"{BODY_TAIL}:{self.body_tail.codec.name}")
